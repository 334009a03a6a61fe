"""Share of ``quant_lb2``'s roofline (%): the least time the H100
could take for the window's calls (``laws/kernels/quant_lb2.py`` over the
recorded shapes) over the kernel's device time in the trace."""
from perfbench.trace import roofline_share


def read(run):
    return roofline_share(run, "quant_lb2")
