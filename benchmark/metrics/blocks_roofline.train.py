"""blocks_roofline.train: the generator blocks' share of their roofline, in %:
the least time the card could take for the blocks' forward and backward at the
step's shapes (`benchmark/counts.py`: the larger of the FLOP over the dense
bf16 peak and the bytes over HBM bandwidth) over their device time: CUDA
events around the blocks' own forward and autograd backward, run on the
activations captured from a traced step."""


def read(readings: dict):
    blocks = readings.get("blocks")
    if readings.get("kind") != "train" or not blocks or not blocks.get("device_s"):
        return None
    return 100.0 * blocks["bound_s"] / blocks["device_s"]
