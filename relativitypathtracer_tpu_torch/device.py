"""The device every entry point of the port uses unless its caller names
another: the card. Callers that want the plain PyTorch twins (the CPU tests,
`--device cpu`) pass device="cpu" explicitly."""

DEFAULT_DEVICE = "cuda"
