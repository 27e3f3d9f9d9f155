"""Per cent of its roofline at which the selective scan (K4) runs: the bytes
it must move (dA and dBx read as float32, C read, y written, the state
read and written at each call; from the port's counters `mamba.tokens`
and `mamba.scans`) at 3.35 TB/s, over the device seconds of what the
port's span `repro_torch.mamba.scan` launched."""
from portbench.spans_mamba import ssm_scan_roofline


def read(ctx):
    return ssm_scan_roofline(ctx)
