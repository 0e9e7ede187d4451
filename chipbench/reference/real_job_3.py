"""Plain NumPy reference of Real Job 3 (arXiv:1602.03770 Sec. 5.3).

airline (source, keyed by airplane) → ExtractDelay (delay = departure +
arrival delay, keyed by airplane) → SumDelay (running sum per (airplane,
year)) and RouteDelay (running sum per (origin, dest), keyed by the route
code origin · airports + dest).  Restated here from the paper's job, with
nothing of the program imported: the operators' key groups come from the
frozen hash (:mod:`chipbench.reference.hashing`) and the sums from
``np.bincount`` in admission order (a left-to-right float64 fold per key).

What the comparison holds the program to (each with its limit from the
configuration's ``limits``):

* ``count_err``: processed, emitted and sink tuples against 4, 4 and 2 per
  admitted tuple;
* ``arrival_err``: key groups whose arrival count (every hop, since the
  engine started) differs;
* ``key_err``: state keys missing, extra, or held by a key group they do not
  hash to;
* ``sum_err``: the largest gap of a key's sum from the reference's, over the
  sum of that key's absolute addends.
"""

from __future__ import annotations

import numpy as np

from chipbench.reference.hashing import int_keygroups

OPERATORS = 4  # airline, extract, sumdelay, routedelay
_YEARS = 10  # the airline year column spans 2004..2013
_YEAR0 = 2004


class Reference:
    """Feed every admitted source batch in admission order; ``dtype`` is the
    float type the sums accumulate in (float32 for the control)."""

    def __init__(self, config: dict, alloc: np.ndarray, *, dtype=np.float64):
        gen = config["generator"]["params"]
        self.kgs = config["keygroups_per_op"]
        self.planes = gen["num_airplanes"]
        self.airports = gen["num_airports"]
        self.dtype = np.dtype(dtype)
        self.arrivals = np.zeros(4 * self.kgs, dtype=np.int64)
        self.plane_sum = np.zeros(self.planes * _YEARS, dtype=self.dtype)
        self.plane_abs = np.zeros(self.planes * _YEARS)
        self.plane_n = np.zeros(self.planes * _YEARS, dtype=np.int64)
        self.route_sum = np.zeros(self.airports**2, dtype=self.dtype)
        self.route_abs = np.zeros(self.airports**2)
        self.route_n = np.zeros(self.airports**2, dtype=np.int64)
        self.admitted = 0

    def admit(self, keys: np.ndarray, values: np.ndarray, ts: np.ndarray) -> None:
        k = self.kgs
        planes = values["plane"]
        route = values["origin"] * self.airports + values["dest"]
        for hop, key in enumerate((keys, planes, planes, route)):
            self.arrivals += np.bincount(
                int_keygroups(key, hop * k, k), minlength=4 * k
            )
        delay = values["dep_delay"] + values["arr_delay"]
        py = planes * _YEARS + (values["year"] - _YEAR0)
        for idx, s, a, n in (
            (py, self.plane_sum, self.plane_abs, self.plane_n),
            (route, self.route_sum, self.route_abs, self.route_n),
        ):
            if self.dtype == np.float64:
                s += np.bincount(idx, weights=delay, minlength=len(s))
            else:
                np.add.at(s, idx, delay.astype(self.dtype))
            a += np.bincount(idx, weights=np.abs(delay), minlength=len(a))
            n += np.bincount(idx, minlength=len(n))
        self.admitted += len(keys)

    def _states(self) -> dict:
        """(key group → state dict) of the two sinks, as the program keeps them."""
        k = self.kgs
        out = {}
        for field, s, n, decode, kg_of, base in (
            ("sums", self.plane_sum, self.plane_n,
             lambda i: (i // _YEARS, _YEAR0 + i % _YEARS), lambda i: i // _YEARS, 2 * k),
            ("route_sums", self.route_sum, self.route_n,
             lambda i: divmod(i, self.airports), lambda i: i, 3 * k),
        ):
            live = np.flatnonzero(n)
            kgs = int_keygroups(kg_of(live), base, k)
            for i, kg, v in zip(live.tolist(), kgs.tolist(), s[live].tolist()):
                out.setdefault(kg, {}).setdefault(field, {})[decode(i)] = float(v)
        return out

    def as_program(self) -> dict:
        """What a program that computed this reference would hand over."""
        a = self.admitted
        states = [dict() for _ in range(4 * self.kgs)]
        for kg, st in self._states().items():
            states[kg] = st
        return {
            "admitted": a,
            "arrivals": self.arrivals.copy(),
            "states": states,
            "counts": {"processed_tuples": 4 * a, "emitted_tuples": 4 * a,
                       "sink_tuples": 2 * a},
        }


def _code(key, hi: tuple, mult: int, off: int) -> int:
    """Dense index of a two-part state key, or -1 when a part is out of range."""
    a, b = int(key[0]), int(key[1]) - off
    return a * mult + b if 0 <= a < hi[0] and 0 <= b < hi[1] else -1


def compare(program: dict, ref: Reference, limits: dict) -> list[tuple[str, float, float]]:
    """``(name, reading, limit)`` of every number compared."""
    a = program["admitted"]
    c = program["counts"]
    count_err = (abs(c["processed_tuples"] - 4 * a) + abs(c["emitted_tuples"] - 4 * a)
                 + abs(c["sink_tuples"] - 2 * a) + abs(a - ref.admitted))
    arrival_err = int(np.count_nonzero(program["arrivals"] != ref.arrivals))
    k, na = ref.kgs, ref.airports
    key_err = 0
    sum_err = 0.0
    for field, s, abs_s, n, span, mult, off, base in (
        ("sums", ref.plane_sum, ref.plane_abs, ref.plane_n, (ref.planes, _YEARS), _YEARS,
         _YEAR0, 2 * k),
        ("route_sums", ref.route_sum, ref.route_abs, ref.route_n, (na, na), na, 0, 3 * k),
    ):
        codes, vals, homes = [], [], []
        for kg in range(base, base + k):
            for key, v in program["states"][kg].get(field, {}).items():
                codes.append(_code(key, span, mult, off))
                vals.append(v)
                homes.append(kg)
        idx = np.asarray(codes, dtype=np.int64)
        got = np.asarray(vals, dtype=np.float64)
        home = np.asarray(homes, dtype=np.int64)
        ok = idx >= 0
        key_err += int(np.count_nonzero(~ok))  # undecodable keys
        idx, got, home = idx[ok], got[ok], home[ok]
        part = idx // _YEARS if field == "sums" else idx  # the hop's partition key
        key_err += int(np.count_nonzero(int_keygroups(part, base, k) != home))  # misplaced
        key_err += len(idx) - len(np.unique(idx))  # held twice
        live = n[idx] > 0
        key_err += int(np.count_nonzero(~live))  # extra
        idx, got = idx[live], got[live]
        key_err += int(np.count_nonzero(n)) - len(np.unique(idx))  # missing
        if len(idx):
            gap = np.abs(got - s[idx].astype(np.float64)) / np.maximum(abs_s[idx], 1e-300)
            sum_err = max(sum_err, float(np.nan_to_num(gap, nan=np.inf).max()))
    return [
        ("count_err", float(count_err), limits["count_err"]),
        ("arrival_err", float(arrival_err), limits["arrival_err"]),
        ("key_err", float(key_err), limits["key_err"]),
        ("sum_err", sum_err, limits["sum_err"]),
    ]
