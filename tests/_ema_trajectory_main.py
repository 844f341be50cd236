"""Subprocess body of
test_torch_train.py::test_ema_trajectory_matches_jax.

The JAX side of the test (`jax_ema_step_trajectory`: 3 float32
`ema_semi_step`s of the JAX package) in a fresh interpreter: the step's jit
is a large new executable, and in a long-lived xdist worker the XLA:CPU
compile cache can abort on one (ROADMAP.md, Queue 3). Writes the arrays the
test compares to an .npz.

    python tests/_ema_trajectory_main.py <accum> <out.npz>
"""

import os
import sys
import tempfile
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from semisupervisedobjectdetection_tpu.utils.cache import (  # noqa: E402
    setup_compile_cache,
)

# a private persistent cache per case and per checkout, under the temporary
# directory (TMPDIR): no two processes of one suite, and no two checkouts'
# suites run side by side, share a cache directory; a repeated run of one
# checkout skips the compile
CASE = f"ematraj_{sys.argv[1]}"
CHECKOUT = f"{zlib.crc32(os.path.dirname(HERE).encode()):08x}"
setup_compile_cache(os.path.join(tempfile.gettempdir(),
                                 f"jax_test_cache_{CASE}_{CHECKOUT}"),
                    min_compile_secs=0.5)

import numpy as np  # noqa: E402

from test_torch_train import jax_ema_step_trajectory  # noqa: E402


def main(accum: int, out: str) -> None:
    np.savez(out, **jax_ema_step_trajectory(accum))
    print("ema-trajectory-jax-ok")


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
