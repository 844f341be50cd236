"""Subprocess body of
test_torch_train_mode.py::test_train_mode_ema_trajectory_matches_jax.

The JAX side of the test (`jax_ema_trajectory`: 3 float32 train-mode EMA
steps of the JAX package) in a fresh interpreter: the step's jit is a large
new executable, and in a long-lived xdist worker the XLA:CPU compile cache
can abort on one (CLAUDE.md, round 3). Writes the arrays the test compares
to an .npz.

    python tests/_train_mode_ema_main.py <accum> <out.npz>
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from test_torch_train_mode import jax_ema_trajectory  # noqa: E402


def main(accum: int, out: str) -> None:
    np.savez(out, **jax_ema_trajectory(accum))
    print("train-mode-ema-jax-ok")


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
