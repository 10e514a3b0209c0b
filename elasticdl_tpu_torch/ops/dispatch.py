"""Device policy for the PyTorch port.

The JAX package decides per backend whether a call site reaches its
Pallas kernels (elasticdl_tpu/ops/dispatch.py). Here the decision is
made by the tensor: a CUDA tensor goes to the hand-written kernel (or
the wrapper raises), a CPU tensor goes to the kernel's plain PyTorch
version. There is no switch that sends a CUDA tensor to the plain path.

Entry points (models, engine, server) take a `device` argument that
defaults to "cuda" and raise when CUDA is missing, so a machine without
a card never runs the port silently on the CPU; tests ask for "cpu"
explicitly.
"""

import torch


def resolve_device(device="cuda"):
    """`device` as a torch.device; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    return dev


def on_kernel_path(*tensors):
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every tensor lies on the CPU (run the plain version).
    Mixed or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(
        "tensors must all lie on one CUDA device or all on the CPU, got %s"
        % sorted(kinds)
    )
