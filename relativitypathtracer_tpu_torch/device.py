"""The device every entry point of the port uses unless its caller names
another: the card. Callers that want the plain PyTorch twins (the CPU tests,
`--device cpu`) pass device="cpu" explicitly."""

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """`device` as a torch.device naming one card: an index-less CUDA device
    ("cuda", torch.device("cuda")) becomes the card current now; any other
    device is returned as it is. A renderer resolves its device once, at
    build, so that its constants, its static inputs and its graph stay on
    that card whichever card is current at a later call."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
