"""The dual-softmax kernels' share of their roofline (ops/fused_dsm.py,
csrc/dual_softmax.cu): the least time of one product over the live cells
of each traced pair at the bf16 peak, or of reading the fp32 features and
masks once and writing the row and column results once at the HBM peak,
whichever is longer, over the device time of both passes' sweeps and
combines in the traced stretch, by kernel name."""

from portbench.roofline import roofline_share

UNIT = "%"
LAYER = "dual-softmax kernels"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
KERNELS = ("pass1_kernel", "pass2_kernel", "combine1_kernel",
           "combine2_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    seconds = t.seconds_of(*KERNELS)
    if seconds <= 0:
        return None
    return roofline_share(ctx.counters["traced_dsm_flops"],
                          ctx.counters["traced_dsm_bytes"], seconds)
