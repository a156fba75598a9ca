"""Mean host milliseconds of one ``EnhanceService.dispatch`` call (the
enqueue of a shot's work), on the benchmark's host clock around each call.
The serving mix's traced window records the device's activity only
(``trace_host_ops`` false), so a call pays what it pays untraced, but for
the profiler's record of its launches."""


def read(run):
    d = run.spans.get("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
