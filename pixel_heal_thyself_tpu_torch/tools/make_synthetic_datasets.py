"""Regenerate the synthetic quality-evidence datasets.

Port of the JAX package's `tools/make_synthetic_datasets.py`: the same four
`generate_dataset` calls (roots, scenes, 512² frames, `noise_scale`, seeds
990819 and 77) through the port's `data/synthetic.py`, which writes the
JAX package's files byte for byte. The EXRs (~3 GB) are deterministic
functions of these seeds and are not committed. A host tool: no device
work.

    python -m pixel_heal_thyself_tpu_torch.tools.make_synthetic_datasets [--root data]

then, for example:

    python -m pixel_heal_thyself_tpu_torch.train -cn prod \
        data.images.dir=$PWD/data/images_prod_synth
"""

from __future__ import annotations

import argparse

from pixel_heal_thyself_tpu_torch.data.synthetic import generate_dataset

# the training channel: 10 frames over 4 scene families (the reference's
# fftle0/1 + taccturb0/1 scene naming, three frames each except taccturb1,
# which has one)
TRAIN_SCENES = [f"{family}{i}_{j}" for family in ("fftle", "taccturb")
                for i in range(2) for j in range(3)][:10]
HELDOUT_SCENES = ["heldout0_0", "heldout1_0"]


def run(root: str = "data", size: int = 512) -> None:
    """The four datasets under `root`, at `size`² (512² as published; a
    smaller `size` for a quick check of the tool)."""
    generate_dataset(f"{root}/images_prod_synth", scenes=TRAIN_SCENES, height=size, width=size,
                     seed=990819)
    # the held-out channel: two scenes from another seed, never trained on
    generate_dataset(f"{root}/images_heldout_synth", scenes=HELDOUT_SCENES, height=size,
                     width=size, seed=77)
    # the cleaner channels: the same scenes and seeds at noise_scale 0.75,
    # a 32-spp analog about 12 dB above the 3.0 default's input PSNR
    generate_dataset(f"{root}/images_prod_synth_clean", scenes=TRAIN_SCENES, height=size,
                     width=size, noise_scale=0.75, seed=990819)
    generate_dataset(f"{root}/images_heldout_synth_clean", scenes=HELDOUT_SCENES, height=size,
                     width=size, noise_scale=0.75, seed=77)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        prog="pixel_heal_thyself_tpu_torch.tools.make_synthetic_datasets", description=__doc__)
    parser.add_argument("--root", default="data", help="directory to place the datasets in")
    run(parser.parse_args(argv).root)


if __name__ == "__main__":
    main()
