"""loader_wait_ms.train: the mean host time a step waits in the loader's
`next()` (the program's `DeviceLoader`), in ms, over the traced run's
window, from the harness's span around the call."""


def read(readings: dict):
    if readings.get("kind") != "train" or "loader_wait_ms" not in readings:
        return None
    return readings["loader_wait_ms"]
