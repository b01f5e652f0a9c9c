"""Model: the share of the traced window's device time in elementwise,
copy and reduction kernels (family "other" of the frozen kernel families,
perfbench/yardstick.py)."""

from perfbench import yardstick


def read(m):
    t = m["trace"]
    if t is None:
        return None
    by_name = t.by_name()
    total = sum(by_name.values())
    other = sum(s for n, s in by_name.items() if yardstick.kernel_family(n) == "other")
    return 100.0 * other / total if total > 0 else None
