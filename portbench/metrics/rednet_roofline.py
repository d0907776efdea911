"""RedNet against its roofline: the float32 operations it needs for every
lane's frame of the traced steps (``portbench/flops_rednet.py``, from its
widths) at the card's float32 peak, over the device time of the kernels
launched in the program's ``rednet`` range (the network alone, without
its input preparation and argmax), in %. Bound by compute: its
convolutions are large and TF32 is off."""


def read(summary):
    flops = summary.get("rednet_flops")
    device_us = summary.get("by_range_us", {}).get("rednet")
    if not flops or not device_us:
        return None
    least_s = flops / summary["peak_flops"]
    return 100.0 * least_s / (device_us * 1e-6)
