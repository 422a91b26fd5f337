"""idle_pct: the share of one traced solve's wall in which no operation
ran on the card (one minus the union of the device's kernel, copy and set
intervals over the wall, from torch.profiler), in %."""


def read(records: dict):
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
