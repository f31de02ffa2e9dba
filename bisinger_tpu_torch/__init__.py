"""PyTorch/CUDA port of the BiSinger singing-voice synthesis stack.

The JAX package `bisinger_tpu` is the reference; this package runs its
flagship inference path (score -> bilingual front end -> FastSpeech2MIDI
-> diffusion over a DiffNet (PLMS, DPM-Solver++ or DDPM) -> PitchExtractor
f0 -> NSF HiFi-GAN -> waveform) on an NVIDIA H100, through the
`run --infer` CLI, the HTTP server (`inference/server.py`) or
`SVSInferTorch`. It imports torch, numpy and scipy only.

Public layouts follow the reference: activations are [B, T, C].
"""

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. The CPU runs only when asked for by name;
    with no card and no explicit CPU request this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device found")
    return device


def full_fp32() -> None:
    """Run fp32 convolutions and matrix products in full fp32 on the card.
    PyTorch's default lets cuDNN take fp32 convolutions in TF32 (a 10-bit
    mantissa); the port's fp32 parts (the GAN's discriminators among them)
    are held against the JAX package and the CPU in fp32, and its times are
    measured so. Every entry point calls this first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
