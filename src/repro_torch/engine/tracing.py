"""The engine's spans, and their innermost-span timeline.

With ``Engine.spans`` set to a list, the engine appends a ``(name, start,
end)`` span at each of its layer boundaries, in ``time.perf_counter``
seconds: the clock onto which a device trace's timestamps can be mapped,
so the spans line up with the device's timeline as they are.  Each site
also adds its interval to an ``EngineMetrics`` counter, spans or not.
``<op>`` is an operator's name.

=====================  =====================================================
span                   interval (counter)
=====================  =====================================================
``tick``               ``Engine.tick``, the whole call
``admit``              ``Engine.push_source``, the whole call
                       (``admit_seconds``: its self time)
``route:<op>``         ``_route_batch`` to ``<op>`` (``route_seconds[op]``)
``route.device:<op>``  a device round trip of routing: upload, kernels,
                       download (``device_route_seconds``)
``route.stats:<op>``   send pairs counted (compaction included) and
                       cross-node usage (``stats_seconds``)
``route.gather:<op>``  the composite sort and the gather by its order
                       (``gather_seconds``: its self time, the gather)
``route.enqueue:<op>`` the runs pushed onto the nodes' queues
``op:<op>``            an operator body: an ``fn_seg`` call, or a per-run
                       ``fn`` loop over a segment (``op_seconds[op]``: its
                       self time, less a compiled-tier flush it forced)
``jit``                the compiled tier's flush of a tick (``jit_seconds``)
``jit.put:<op>``       pushes of dict state, padding and uploads of one call
                       (``jit_put_seconds``)
``jit.call:<op>``      the ``fn_jit`` body's call (``jit_call_seconds``)
``jit.fetch:<op>``     the call's one synchronization and its reads
                       (``jit_fetch_seconds``)
``flush:<op>``         ``_flush_outputs`` for ``<op>``: cells expanded,
                       batches conformed and concatenated, sources
                       attributed, up to its routing (``flush_seconds``)
``fold.pairs``         ``Engine.end_period``'s fold of the statistics
                       window: the send pairs' rates, the loads
``milp.build``         a MILP solve of the controller's period, up to
                       HiGHS: its rows and the solver's sparse matrix
                       (``PeriodMetrics.milp_build_seconds``)
``milp.highs``         that solve's HiGHS call
                       (``PeriodMetrics.milp_highs_seconds``)
=====================  =====================================================

The two ``milp`` spans are the controller's (``Controller.period``), one
pair a solve, ALBIC's back-offs among them, appended after the period's
adaptation from the times its plans carry; their counters are the
period's sums.

Spans of one thread nest by containment: a span's parent is the smallest
span that encloses it, and the top-level spans are ``tick``, ``admit``,
``fold.pairs`` and the ``milp`` spans.  No counter holds another's
interval, except ``route_seconds``, which holds ``device_route_seconds``,
``gather_seconds`` and ``stats_seconds``.
"""

from __future__ import annotations


def flatten(spans) -> list[tuple[str, float, float]]:
    """The innermost-span timeline of nested ``(name, start, end)`` spans:
    disjoint intervals in time order, each instant given to the innermost
    span open at the time.  Their union is the union of the top-level
    spans.  A span reaching past its parent's end is cut there."""
    out: list[tuple[str, float, float]] = []
    stack: list[tuple[str, float]] = []  # open spans: (name, end)
    t = float("-inf")  # how far the timeline is laid out
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            top, end = stack.pop()
            if end > t:
                out.append((top, t, end))
                t = end
        if stack and s > t:
            out.append((stack[-1][0], t, s))
        t = max(t, s)
        stack.append((name, min(e, stack[-1][1]) if stack else e))
    while stack:
        top, end = stack.pop()
        if end > t:
            out.append((top, t, end))
            t = end
    return out
