"""Subprocess body of test_torch_fp8_depth.py::test_fp8_full_depth_against_jax.

The JAX side in a fresh interpreter (a full-depth MiT-B5 forward is a large
new executable, and in a long-lived process the XLA:CPU compile cache can
abort on one; ROADMAP.md, Queue 3): the port's seeded weights, handed over
in an .npz by HF key, are carried into the JAX package's variables by its
own importer (`checkpoint/hf_import.py::import_torch_state_dict`), then
`SegFormer(cfg).apply` predicts the images in float32 and bfloat16, and
`SegFormer(qcfg).apply` on the eagerly quantized trees
(`ops/quant.py::quantize_dense_params`, as the JAX package's `quantize()`
runs it) in int8 and fp8, one image a call. Writes the masks to an .npz.

    python tests/_fp8_depth_main.py <in.npz> <out.npz>
"""

import os
import sys
import tempfile
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from semisupervisedobjectdetection_tpu.utils.cache import (  # noqa: E402
    setup_compile_cache,
)

# a private persistent cache for this case and checkout, under the
# temporary directory (TMPDIR)
CHECKOUT = f"{zlib.crc32(os.path.dirname(HERE).encode()):08x}"
setup_compile_cache(os.path.join(tempfile.gettempdir(),
                                 f"jax_test_cache_fp8depth_{CHECKOUT}"),
                    min_compile_secs=0.5)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from semisupervisedobjectdetection_tpu.checkpoint.hf_import import (  # noqa: E402,E501
    import_torch_state_dict,
)
from semisupervisedobjectdetection_tpu.core.config import mit_b5  # noqa: E402
from semisupervisedobjectdetection_tpu.models.segformer import (  # noqa: E402
    SegFormer,
    predict_masks,
)
from semisupervisedobjectdetection_tpu.ops import quant  # noqa: E402

WIDTHS = ("float32", "bfloat16", "int8", "fp8")


def main(src: str, out: str) -> None:
    with np.load(src) as f:
        data = dict(f)
    images = data.pop("__images__")
    size = images.shape[1]
    cfg = mit_b5(dtype="float32", gelu_approx=True)
    shapes = jax.eval_shape(SegFormer(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = import_torch_state_dict(
        data, cfg, zeros["params"], zeros["batch_stats"])
    masks = {}
    for width in WIDTHS:
        wcfg = cfg.replace(dtype="float32" if width == "float32"
                           else "bfloat16")
        p = params
        if width in ("int8", "fp8"):
            wcfg = wcfg.replace(quant=width)
            p = jax.tree.map(np.asarray,
                             quant.quantize_dense_params(params, kind=width))

        @jax.jit
        def predict(p, stats, x, wcfg=wcfg):
            logits, _ = SegFormer(wcfg).apply(
                {"params": p, "batch_stats": stats}, x)
            return predict_masks(logits, x.shape[1:3])

        masks[width] = np.concatenate([
            np.asarray(predict(p, stats, jnp.asarray(images[i:i + 1])))
            for i in range(images.shape[0])])
        print(f"{width} done", flush=True)
    np.savez(out, **masks)
    print("fp8-depth-jax-ok")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
