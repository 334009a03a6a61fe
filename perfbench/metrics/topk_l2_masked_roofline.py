"""Share of ``topk_l2_masked``'s roofline (%): the least time the H100
could take for the window's calls (``laws/kernels/topk_l2_masked.py`` over the
recorded shapes) over the kernel's device time in the trace."""
from perfbench.trace import roofline_share


def read(run):
    return roofline_share(run, "topk_l2_masked")
