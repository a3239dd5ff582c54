"""mfu.train: the train steps' model FLOP per second over the card's dense bf16
peak, in %. The FLOP are the benchmark's own count (`benchmark/counts.py`):
the reference step's per patch, times the patches per second of
the traced run's steps before its first traced stretch."""

from benchmark.counts import PEAK_FLOPS


def read(readings: dict):
    if readings.get("kind") != "train" or "items_per_s" not in readings:
        return None
    return 100.0 * readings["flops_per_item"] * readings["items_per_s"] / PEAK_FLOPS["bf16"]
