"""Write the synthetic dataset of the convergence runs
(tools/gen_scenes_r4.py on the port).

    python -m tecogan_tpu_torch.tools.gen_scenes_r4 --root <dir> [--size 144]

420 scenes (``scene_1000`` .. ``scene_1419``: 408 for training, 12 for
validation) and 3 held-out evaluation scenes (``scene_2100`` ..
``scene_2102``, disjoint seeds), 120 frames each, through the full variety
of ``data.synthetic.write_synthetic_scene_folders``: the JAX tool's scenes,
pixel for pixel (PNG files written with PIL, the JAX package's with
imageio).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..data.synthetic import write_synthetic_scene_folders


def write_round_scenes(root: str, size: int = 144, train_scenes: int = 420,
                       heldout_scenes: int = 3, frames_per_scene: int = 120) -> None:
    """The training and validation block from index 1000 (``seed_offset``
    0) and the held-out scenes from 2100 (``seed_offset`` 1000) under
    ``root``."""
    write_synthetic_scene_folders(root, num_scenes=train_scenes,
                                  frames_per_scene=frames_per_scene, size=size,
                                  start_index=1000, variety=True, seed_offset=0)
    write_synthetic_scene_folders(root, num_scenes=heldout_scenes,
                                  frames_per_scene=frames_per_scene, size=size,
                                  start_index=2100, variety=True, seed_offset=1000)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", required=True, help="directory the scene folders go into")
    p.add_argument("--size", type=int, default=144)
    args = p.parse_args(argv)
    t0 = time.time()
    write_round_scenes(args.root, args.size)
    print(f"done in {time.time() - t0:.0f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
