"""PyTorch/CUDA port of the semi-supervised archaeological-site segmentation
system, for one NVIDIA H100 (Hopper, sm_90a).

It stands beside the JAX package `semisupervisedobjectdetection_tpu`, which
stays the reference, and imports nothing of it. This slice serves SegFormer
(MiT B0-B5): `api.SegFormerModel` and `cli/serve.py`, with SR-attention as
a hand-written CUDA kernel (`csrc/sr_attention_fwd.cu`). Entry points run
on the CUDA card unless the caller passes device="cpu".
"""
