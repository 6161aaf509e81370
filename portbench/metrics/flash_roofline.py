"""The flash prefill kernels' share of their roofline: the least time the
card could take for the launches of the whole profiler sessions (each
launch's flops and bytes from its recorded shapes, ``roofline.flash_cost``)
over the device time of those kernels in the profile. None where no
session kept every flash launch."""


def read(record):
    f = record.get("flash")
    if not f or not f["kernel_s"]:
        return None
    return 100.0 * f["least_s"] / f["kernel_s"]
