"""K1 (accumulate) and K2 (rasterize) together against their roofline: the
least time their bytes take at the HBM bandwidth
(``portbench/flops.py::mapper_bytes``, counted from each traced step's
inputs) over their device time by kernel name, in %. Both are bound by
bytes: their float32 work is a few operations per point."""

KERNELS = ("accumulate_tile", "rasterize_cluster")


def read(summary):
    nbytes = summary.get("mapper_bytes")
    device_us = sum(us for name, us in summary.get("kernels_us", {}).items()
                    if any(k in name for k in KERNELS))
    if not nbytes or not device_us:
        return None
    least_s = nbytes / summary["peak_bytes_per_s"]
    return 100.0 * least_s / (device_us * 1e-6)
