"""blocks_roofline.serve: the generator blocks' share of their roofline, in %:
the least time the card could take for the blocks' forward over the traced
frames' windows (`benchmark/counts.py`: the larger of the FLOP over the dense
bf16 peak and the bytes over HBM bandwidth) over their device time, CUDA
events from the first block's entry to the last block's exit of each batch
in the attribution stretch."""


def read(readings: dict):
    blocks = readings.get("blocks")
    if readings.get("kind") != "serve" or not blocks or not blocks.get("device_s"):
        return None
    return 100.0 * blocks["bound_s"] / blocks["device_s"]
