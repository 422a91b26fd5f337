"""spmv_roofline: one operator product at the request's block width (K2 for
DIA, K6 for CSR, K5 for a block of b rows), its least time on the card's
published peaks over its CUDA-event time, in %.  Its bytes: the stored
values and indices at their stored widths, x read once, y written once."""

from portbench.harness import roofline


def read(records: dict):
    probe = records["probes"].get("spmv")
    peaks = roofline.peak(records["device"]["kind"])
    if probe is None or peaks is None:
        return None
    return roofline.share_pct(probe["bytes"], probe["flops"],
                              probe["ms"] / 1e3, peaks)
