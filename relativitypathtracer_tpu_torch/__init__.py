"""relativitypathtracer_tpu_torch: the PyTorch/CUDA port of the
special-relativity ray tracer, for one NVIDIA H100.

It mirrors `relativitypathtracer_tpu` module by module (that JAX package is
the reference and is not imported here): the same scene DSL and host
structures, the same rays-last tensor layout and 1024-ray tile blocks, with
each TPU Pallas kernel of the ported path replaced by a hand-written CUDA
kernel under csrc/ (built with nvcc at first use) beside a plain PyTorch
twin that CPU tensors take.
"""

from .models.dsl import load_scene_file, parse_scene
from .models.scene import build_scene, scene_from_numpy
from .render import FrameState, build_render_fn, render_frame

__all__ = [
    "load_scene_file",
    "parse_scene",
    "build_scene",
    "scene_from_numpy",
    "FrameState",
    "build_render_fn",
    "render_frame",
]

__version__ = "0.1.0"
