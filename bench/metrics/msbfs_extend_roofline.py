"""``msbfs_extend``'s share of its roofline in the traced window: the
least time of its launches (``harness/kernel_bytes.extend_bytes`` over
3.35 TB/s) over their device time (%)."""
from harness import probes

KERNEL = "msbfs_extend"
DEVICE_NAME = "extend_kernel"


def install(run):
    probes.attach(run).install_msbfs_extend()


def read(run):
    return probes.roofline(run, KERNEL, DEVICE_NAME)
