"""cheb_cols: the Chebyshev driver's columns (``eps.cheb_stats['cols']``:
the probe's plain columns and every filtered column) per solve, the mean
over the traced run's solves.  Fewer columns, less filtering."""


def read(records: dict):
    cols = [s["stats"]["cols"] for s in records["solves"]
            if "cols" in s.get("stats", {})]
    return sum(cols) / len(cols) if cols else None
