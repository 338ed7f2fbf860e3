"""Kernel B2 (csrc/fused_resample.cu `fused_kernel`): the least time the
card could take for the traced window's thumbnail and resize pairs,
counted from each real image's own extent (roofline.b2_work: the
32-byte sectors the taps touch), over the summed time of its launches in
the trace, in percent. Set by bytes at 3.35 TB/s."""

from perfbench import roofline

LAYER = "kernels"
UNIT, SOURCE, MOVES = "%", "device_trace", "images_per_s"
KERNEL = "fused_kernel"


def read(run):
    t = sum(b - a for n, _c, a, b in run.device_events if KERNEL in n)
    least = 0.0
    for s in run.spans.of("device_group", run.trace_lo, run.trace_hi):
        if "thumbnail" in s.info["ops"] and "resize" in s.info["ops"]:
            least += sum(roofline.bound_s(*roofline.b2_work(h, w))[0]
                         for h, w in s.info["hw"])
    return 100.0 * least / t if t > 0 and least > 0 else None
