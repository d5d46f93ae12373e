"""PyTorch/CUDA port of clap2diffusion_tpu: audio + text -> 512x512 image.

The JAX package beside this one is the reference. This package imports
torch, numpy and the standard library only; it never imports jax, flax or
``clap2diffusion_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
