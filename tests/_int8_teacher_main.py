"""Subprocess body of
test_torch_int8_teacher.py::test_int8_teacher_step_matches_jax.

The JAX side of the test (`jax_int8_teacher_steps`: the JAX package's int8
teacher snapshot and one `ema_semi_step_int8` at accum 1 and at accum 2)
in a fresh interpreter: the step's jit is a large new executable, and in a
long-lived xdist worker the XLA:CPU compile cache can abort on one
(ROADMAP.md, Queue 3). Writes the arrays the test compares to an .npz.

    python tests/_int8_teacher_main.py <out.npz>
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
CASE = "int8teacher"
CHECKOUT = f"{zlib.crc32(os.path.dirname(HERE).encode()):08x}"
setup_compile_cache(os.path.join(tempfile.gettempdir(),
                                 f"jax_test_cache_{CASE}_{CHECKOUT}"),
                    min_compile_secs=0.5)

import numpy as np  # noqa: E402

from test_torch_int8_teacher import jax_int8_teacher_steps  # noqa: E402


def main(out: str) -> None:
    np.savez(out, **jax_int8_teacher_steps())
    print("int8-teacher-jax-ok")


if __name__ == "__main__":
    main(sys.argv[1])
