"""idle_pct.serve: the share of the time with no operation on the card
(kernels, copies, memsets), in %: one less the device's busy seconds per
frame in the traced steady stretch over the host seconds per frame of the
window's frames before it, when no profiler had run in the process (tracing
slows the host, not the device, and its slowing outlasts the stretch).
Nothing when the stretch saw no device operation."""


def read(readings: dict):
    trace = readings.get("trace") or {}
    if readings.get("kind") != "serve" or not trace.get("busy_s") or not trace.get("items"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["items"] / trace["item_s"])
