"""Subprocess body of
test_torch_train.py::test_gradients_match_jax_value_and_grad.

The JAX side of the test (`jax_value_and_grad`: the loss, logits and
parameter gradients of the JAX model under remat) in a fresh interpreter:
the jit of the loss's value and gradient is a large new executable, and in
a long-lived xdist worker the XLA:CPU compile cache can abort on one (as
tests/_train_mode_ema_main.py says). Writes the arrays the test compares to
an .npz.

    python tests/_grad_parity_main.py <case> <out.npz>
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

from test_torch_train import jax_value_and_grad  # noqa: E402


def main(case: str, out: str) -> None:
    np.savez(out, **jax_value_and_grad(case))
    print("grad-parity-jax-ok")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
