"""Kernels 1-2 (``csrc/bin_max2.cu``): the least time of every launch in
the traced window, worked out from its shape with the frozen bound
arithmetic (``reference/roofline.py``), over the profiler's time of the
same launches, in %. Nothing when no launch was traced or the trace's
launches do not match the recorded ones."""

from portbench.reference.roofline import bin_max_pass_bound_s

KERNEL = "bin_max_kernel"  # the template every pass of bin_max2.cu instances


def read(win):
    tr = win.trace
    if tr is None or not win.launch_shapes:
        return None
    times = [d for name, _, d in tr.kernels if KERNEL in name]
    if len(times) != len(win.launch_shapes) or not sum(times):
        return None
    bound = sum(bin_max_pass_bound_s(B, E, n_pad, L, keep, thr)
                for _, B, E, n_pad, L, keep, thr in win.launch_shapes)
    return 100.0 * bound / sum(times)
