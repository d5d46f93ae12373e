"""PyTorch/CUDA port of clap2diffusion_tpu: audio + text -> 512x512 image.

The JAX package beside this one is the reference. This package imports
torch, numpy and the standard library only; it never imports jax, flax or
``clap2diffusion_tpu``. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""


def pipeline(cfg=None, params=None, seed: int = 0, device=None):
    """An ``AudioToImagePipeline`` of ``cfg`` (``Config()`` by default) from
    ``params``, or drawn at random from ``seed``, on ``device`` (CUDA
    unless ``device="cpu"``); imported on call, so that importing the
    package stays light."""
    from clap2diffusion_tpu_torch.core.config import Config
    from clap2diffusion_tpu_torch.diffusion.pipeline import AudioToImagePipeline

    return AudioToImagePipeline(cfg or Config(), params=params, seed=seed, device=device)
