"""dispatch.host_plan_ms: ms of run_radsurf's host plan a call, the spans
dispatch.plan (models/dispatch.py _plan: tile groups, the gathers, AUTO's
memory query, chunk resolution) and graphs.pack (utils/graphs.py: the
pinned staging of the host inputs), over the calls that recorded
dispatch.plan.  The program's spans (utils/profiling.hook) record while a
profiler runs, so in a run of the benchmark these are the traced calls,
slowed by the profiler: an upper bound for an untraced call.  None where
the program records no such span, or has no profiling.counts() (a program
older than these spans)."""


def read(t):
    from spartacus_surface_tpu_torch.utils import profiling

    counts = getattr(profiling, "counts", None)
    calls = counts().get("dispatch.plan", 0) if counts else 0
    if not calls:
        return None
    totals = profiling.totals()
    return 1e3 * (totals["dispatch.plan"] + totals.get("graphs.pack", 0.0)) / calls
