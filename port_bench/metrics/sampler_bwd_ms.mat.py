"""sampler_bwd_ms.mat: device ms a step of the texture sampler's
backward: the gathers' scatter-add (PyTorch's index_put_ with accumulate:
its radix sort of the taps and its indexing-backward kernel) or, with
the program's segment-sum switch, kernel S (csrc/scatter_acc.cu).  The
kernel-name filter below is frozen."""

UNIT = "ms"
MOVES = "mat_steps_per_s"
KERNELS = ("indexing_backward_kernel", "DeviceRadixSortOnesweepKernel",
           "DeviceRadixSortHistogramKernel",
           "DeviceRadixSortExclusiveSumKernel", "scatter_sorted_kernel",
           "scatter_unsorted_kernel")


def read(r):
    if r.kind != "mat" or r.trace is None:
        return None
    ms = r.trace.kernel_ms(lambda name: any(k in name for k in KERNELS))
    return r.per_unit(ms) if ms > 0 else None
