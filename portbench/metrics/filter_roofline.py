"""filter_roofline: one Chebyshev filter apply (``ChebAmplifyOperator(A,
lo, hi, degree).mult`` or ``.mult_block`` at the request's block width, the
window of the traced run's last solve), its least time on the card's
published peaks over its CUDA-event time, in %.  Each step's bytes: the
operator's stored entries and indices once, t_k and t_{k-1} read once,
t_{k+1} written once, whatever implements the step."""

from portbench.harness import roofline


def read(records: dict):
    probe = records["probes"].get("filter")
    peaks = roofline.peak(records["device"]["kind"])
    if probe is None or peaks is None:
        return None
    return roofline.share_pct(probe["bytes"], probe["flops"],
                              probe["ms"] / 1e3, peaks)
