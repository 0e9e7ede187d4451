"""Plain reference of Real Job 1 (arXiv:1602.03770 Sec. 5.2).

wiki (source, keyed by article) → GeoHash (the article's pseudo-location in
Denmark, geohashed to 5 characters) → windowed TopK (keyed by geohash: per
key group, article counts over a window of ``window_ticks`` of stream time;
the tuple that closes a window is counted in it, then the ``topk`` most
counted articles, ties in first-seen order, go downstream) → global TopK
(one key group: the same window over the rankings' counts; its rankings are
the job's output).  Restated from the paper's job with nothing of the
program imported.  The geohash and pseudo-location are frozen copies of
``src/repro_torch/data/jobs.py``'s scalar ``_geohash`` and ``geohash_run``
as of commit 1b40d26; key groups come from the frozen hash, and the
geohash hop is placed by Python's ``hash`` as the engine places it (the
harness fixes ``PYTHONHASHSEED``).

A window's content depends on the order its tuples arrive in, so the
reference follows the engine's delivery order, which is part of its
semantics: each hop stably sorts a batch by (node of the key group, key
group), every node's queue drains in node order, and outputs reach the next
hop one tick later.  So it needs the allocation, which stays fixed (no
controller in this job's cells).

Numbers compared (limits from the configuration's ``limits``; all exact):
``count_err`` (processed, emitted and sink tuples against the reference's),
``arrival_err`` (key groups whose arrival count differs), ``state_err``
(key groups whose state differs, dict order included) and ``ranking_err``
(global rankings that differ, or are missing or extra).
"""

from __future__ import annotations

import numpy as np

from chipbench.reference.hashing import int_keygroups, keygroup_of

OPERATORS = 4  # wiki, geohash, topk, global_topk
_DK = (54.5, 57.8, 8.0, 12.7)
_B32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash(lat: float, lon: float, precision: int = 5) -> str:
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    bits, ch, even, out = 0, 0, True, []
    while len(out) < precision:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon > mid:
                ch = ch * 2 + 1
                lon_r[0] = mid
            else:
                ch *= 2
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat > mid:
                ch = ch * 2 + 1
                lat_r[0] = mid
            else:
                ch *= 2
                lat_r[1] = mid
        even = not even
        bits += 1
        if bits == 5:
            out.append(_B32[ch])
            bits, ch = 0, 0
    return "".join(out)


def article_geohash(article: int) -> str:
    rng = (int(article) * 2654435761) & 0xFFFFFFFF
    lat = _DK[0] + (rng % 10_000) / 10_000 * (_DK[1] - _DK[0])
    lon = _DK[2] + ((rng // 10_000) % 10_000) / 10_000 * (_DK[3] - _DK[2])
    return geohash(lat, lon)


def _count(counts: dict, arts: np.ndarray) -> None:
    """Add one per article, new articles in first-seen order."""
    uniq, first, cnt = np.unique(arts, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    for art, c in zip(uniq[order].tolist(), cnt[order].tolist()):
        counts[art] = counts.get(art, 0) + c


def _ranking(counts: dict, topk: int) -> list:
    return sorted(counts.items(), key=lambda x: -x[1])[:topk]


class Reference:
    """Feed every admitted source batch in admission order, one a tick.
    ``redeliver`` (the control) breaks exactly-once delivery: each batch's
    first tuple arrives twice."""

    def __init__(self, config: dict, alloc: np.ndarray, *, redeliver: bool = False):
        gen = config["generator"]["params"]
        job = config["topology"]["kwargs"]
        self.kgs = k = config["keygroups_per_op"]
        self.window = float(job["window_ticks"])
        self.topk = int(job["topk"])
        self.alloc = np.asarray(alloc, dtype=np.int64)
        self.redeliver = redeliver
        arts = np.arange(gen["num_articles"])
        ghs = [article_geohash(a) for a in arts.tolist()]
        self.topk_kg = np.array([keygroup_of(g, 2 * k, k) for g in ghs], dtype=np.int64)
        self.global_kg = keygroup_of("global", 3 * k, k)
        self.arrivals = np.zeros(4 * k, dtype=np.int64)
        self.states = [dict() for _ in range(4 * k)]
        self.rankings: list = []  # the global TopK's outputs (key, value, ts)
        self.windows = 0  # rankings the TopK hop emitted
        self.admitted = 0
        self._pending: list = []  # TopK's rankings of the last tick, in emission order

    def _sorted(self, order: np.ndarray, kgs: np.ndarray, base: int) -> np.ndarray:
        """The engine's routing order: a stable sort by (node, key group)."""
        comp = self.alloc[kgs[order]] * self.kgs + (kgs[order] - base)
        return order[np.argsort(comp, kind="stable")]

    def _window(self, state: dict, ts: float, first, rest) -> list:
        """One tick's run of a windowed key group (every tuple of a tick has
        the tick's timestamp): ``first(counts)`` adds the run's first
        tuple, ``rest(counts)`` the others.  Returns the closed window's
        ranking, if the run closed one."""
        counts = state.setdefault("counts", {})
        w_start = state.setdefault("w_start", ts)
        if ts - w_start < self.window:
            first(counts)
            rest(counts)
            return []
        first(counts)
        top = _ranking(counts, self.topk)
        counts.clear()
        state["w_start"] = ts
        rest(counts)
        return [top]

    def admit(self, keys: np.ndarray, values: np.ndarray, ts: np.ndarray) -> None:
        if self.redeliver and len(keys):
            keys, values, ts = (np.concatenate([x[:1], x]) for x in (keys, values, ts))
        if len(np.unique(ts)) > 1:
            raise ValueError("the reference takes batches of one timestamp")
        self._global_tick()
        k = self.kgs
        t = float(ts[0])
        arts = values["article"]
        wiki = int_keygroups(keys, 0, k)
        geo = int_keygroups(arts, k, k)
        top_kg = self.topk_kg[arts]
        for kgs in (wiki, geo, top_kg):
            self.arrivals += np.bincount(kgs, minlength=4 * k)
        order = self._sorted(np.arange(len(keys)), wiki, 0)
        order = self._sorted(order, geo, k)
        order = self._sorted(order, top_kg, 2 * k)  # drain order of TopK
        run_kgs = top_kg[order]
        starts = np.flatnonzero(np.r_[True, run_kgs[1:] != run_kgs[:-1]])
        ends = np.r_[starts[1:], len(order)]
        emitted = []
        for a, z in zip(starts.tolist(), ends.tolist()):
            kg = int(run_kgs[a])
            run = arts[order[a:z]]
            for top in self._window(self.states[kg], t,
                                    lambda c: _count(c, run[:1]), lambda c: _count(c, run[1:])):
                emitted.append((top, t))
        self.windows += len(emitted)
        self._pending = emitted
        self.admitted += len(keys)

    def _global_tick(self) -> None:
        """Global TopK's tick over the rankings TopK emitted a tick before."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        self.arrivals[self.global_kg] += len(pending)

        def add(counts, items):
            for top, _ in items:
                for art, c in top:
                    counts[art] = counts.get(art, 0) + c

        t = pending[0][1]
        for top in self._window(self.states[self.global_kg], t,
                                lambda c: add(c, pending[:1]), lambda c: add(c, pending[1:])):
            self.rankings.append(("global", {"top": top}, t))

    def finish(self) -> None:
        """Deliver what TopK emitted on the last tick."""
        self._global_tick()

    def as_program(self) -> dict:
        a, w, s = self.admitted, self.windows, len(self.rankings)
        return {
            "admitted": a,
            "arrivals": self.arrivals.copy(),
            "states": self.states,
            "sink_outputs": list(self.rankings),
            "counts": {"processed_tuples": 3 * a + w, "emitted_tuples": 2 * a + w + s,
                       "sink_tuples": s},
        }


def compare(program: dict, ref: Reference, limits: dict) -> list[tuple[str, float, float]]:
    """``(name, reading, limit)`` of every number compared."""
    want = ref.as_program()
    c, wc = program["counts"], want["counts"]
    count_err = sum(abs(c[key] - wc[key]) for key in wc) + abs(program["admitted"] - ref.admitted)
    arrival_err = int(np.count_nonzero(program["arrivals"] != ref.arrivals))

    def same(x, y) -> bool:  # equal, dict order included
        if isinstance(x, dict) and isinstance(y, dict):
            return list(x) == list(y) and all(same(x[key], y[key]) for key in x)
        return x == y

    state_err = sum(not same(x, y) for x, y in zip(program["states"], ref.states))
    state_err += abs(len(program["states"]) - len(ref.states))
    got, exp = program["sink_outputs"], ref.rankings
    ranking_err = abs(len(got) - len(exp)) + sum(
        not (x[0] == y[0] and same(x[1], y[1]) and x[2] == y[2]) for x, y in zip(got, exp))
    return [
        ("count_err", float(count_err), limits["count_err"]),
        ("arrival_err", float(arrival_err), limits["arrival_err"]),
        ("state_err", float(state_err), limits["state_err"]),
        ("ranking_err", float(ranking_err), limits["ranking_err"]),
    ]
