#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root:  python3 chip_smoke.py

It needs a CUDA device and nvcc, and fails (non-zero exit, no result line)
without them. It builds the port's CUDA kernels from
relativitypathtracer_tpu_torch/csrc, then drives five paths, each a
procedural fixture (utils/demo_scene) loaded through load_scene_file ->
build_scene -> build_render_fn at 1024x768, interval -1 (light propagation
and shadows on):
  blob       one untextured 5,120-triangle mesh moving at 0.5c and a light
             sphere: K1 shadow chain, K3 analytic nearest hit, K4 live-chunk
             list build (three kernels: the cone table, the cull and the
             counting sort), K5 mesh primary walk, K6 mesh shadow walk;
  textured   the same mesh with a 32x32 texture (512-row footprint atlas),
             bench.py's main path: K1, K2 footprint fetch, K3, K4, K5, K6;
  cubes      nine cubes (eight sharing a 256x256 texture, a 32,768-row
             atlas, one row moving at 0.6c), a floor cube and a light
             sphere: K1, K3, K7 analytic occlusion, K8 footprint fetch;
  instances  that mesh instanced four times (20,480 triangles in one pool of
             640 chunks; different scales, two moving, one textured) and a
             light sphere: K1, K2, K3, K4 (the pool's lists), K9 batched
             primary walk, K10 batched shadow walk, and never K5/K6;
  large      the blob at level 7 (327,680 triangles, 10,240 chunks in 320
             superchunks) moving at 0.5c and a light sphere: K1, K3, K4 (the
             two-level lists), K11 large-tier primary walk, K12 large-tier
             shadow walk, and never K5/K6;
  xl         the JAX package's XL tier: utils/largedemo.load_large_scene at
             levels 4 in a temporary workdir, the reference's bunny
             ($REF_ASSETS/Models/bunny.obj) where it exists, else its
             stand-in (utils/demo_scene.write_bunny_stand_in), subdivided 4
             times: 1,271,808 triangles, 39,744 chunks, above SUPER_CULL_C,
             so live_chunk_lists3 (the cull against super spheres, then the
             chunk bits from one cone a block) and K11/K12 on 311 superchunks
             of 128, the last of 64 chunks, with bit rows of 1,244 words: K1,
             K3, K4, K11, K12, and never K5/K6. The route is checked (the
             super size, lists3 taken and lists2 not, the bit rows' width)
             and the fullest block's live supers and the furthest bit word a
             walk reached are printed.
On large and xl each twin of K11 and K12 runs once, timed once (K12's twin
takes seconds).
For each path it:
  1. calls the renderer once: its first call runs the frame eagerly (the
     warm-up, whose inputs to each kernel step 2 uses), captures it into one
     CUDA graph (utils/frame_graph) and replays it; then renders 3 frames
     with advancing time, the last with the camera moving at 0.5c, each a
     replay of that graph, with every launch count set to 0 just before and
     read just after (a replay counts the graph's launches), and checks the
     image, the counts, and that each of the path's kernels was launched and
     no other; then holds the graphed frames, kept while the later ones
     replayed, and a second scene's graphed frame to the eager frame
     (render_constants, trace_frame) to the bit, counts and launches alike,
     and prints eager and graph p50/p95 in turns (eager, graph, graph,
     eager; 20 frames each), the capture seconds, the bytes a replay copies
     in and that copy's device ms, and the peak memory of both; then
     checks that the kernel nodes of the graph one more counted replay ran
     (utils/frame_graph.kernel_names, read through libcuda: what a
     replay launches) hold each of the path's kernels as many times as the
     replay added to its launch count, and no other kernel of the port, and
     prints how many of them a torch.profiler trace of one more replay
     holds (no verdict: a trace has lacked a kernel that its replay ran);
  2. runs each kernel against its plain PyTorch twin, both on the card, on
     the inputs the first frame gave it (the six mesh walks K5, K6, K9, K10,
     K11 and K12 equal to it bit for bit, with the chunks they walked
     printed: for K5, K9 and K11 against the live chunks of the lists, with
     the heaviest block's share of the tests; for K6, K10 and K12 with the
     tests that testing every lane would take against the active lanes'
     tests; for K9 and K10 also how often a walk changes object), and
     times both (CUDA events, median
     of 20 runs; the kernel's launches replayed from a CUDA graph, each on
     its own copy of the inputs so that none is in L2 when its launch comes,
     so its time is the device's from memory; a broadcast input stays one);
     computes each kernel's bound from those inputs (the cull's from the
     cone tests it ran, read through its skip counter; K3's and K7's from
     the full tests their votes ran, read through their `tested` counters;
     the cone table's from the bytes it must move, a broadcast origin read
     once); times the counting sort's library counterpart, torch.sort of
     the bucket ids (stable), on the same rows; then holds every list build
     of the first frame (K4's three kernels, through the list function the
     walks call) to its
     twin on the same inputs, to the bit, and prints K4's builds, device ms
     and the twin's ms per frame with their bound, and each cull launch's
     ms with the share of (block, 32-chunk group) pairs whose cone tests
     its group pre-test skipped (read through the kernel's counter in a run
     of its own; on large, culls that skip none fail); K3 and K7 equal to
     their twins to the bit (K3's uv within 1e-5), with the share of (warp,
     object) pairs whose full test their vote skipped, read through their
     `tested` counter in a run of its own and held equal to the count of the
     pre-test's plain form (on cubes, a kernel that skips none fails); K2
     and K8, the fetch with its flat-colour select as the frame calls it,
     equal to their twin to the bit, hit colour and atlas quads alike, on a
     frame with textured and untextured lanes;
  3. renders the last frame with the port on the CPU (the plain twins) and
     holds the card's frame to it under the parity rule (at most 0.2% of
     pixels off by more than 1e-3); blob and instances at 512x384, large at
     256x192, xl at 128x96, the others at 1024x768;
  4. times the frame (p50/p95 over 60 frames after 5 warm-up frames, CUDA
     events) and reports Mrays/s counting primary plus shadow rays.
  5. oracle: writes the scene blob (utils/scene_blob) of the card's scene at
     the timed state, renders it with the C++ oracle, compiled from
     native/cpu_reference.cpp into build/oracle/ (utils/parity), and holds
     the card's 1024x768 frame to the oracle's image under the parity rule;
     prints frac_bad, mean_diff and the oracle's p50 ms and threads on the
     card host's CPU;
  6. on xl, the module's own entry: utils/largedemo.large_parity_and_time
     at levels 4 (its scene from the pickle the path's build wrote) and at
     levels 3 (317,952 triangles, superchunks of 32), each ok under the
     parity rule, printed as bench.py prints its large_mesh lines, with the
     pickle load's seconds.
It prints each path's seconds. Then it renders the textured path at msaa 2,
512x384, and holds it to its CPU frame, runs the textures phase:
  textures
          with PIL blocked (sys.modules["PIL"] = None for the phase, restored
          after; no PIL module may be imported meanwhile): every file of
          tests/torch_textures (JPEG, progressive JPEGs with unsent bits,
          PNG, PNGs PIL reads though a CRC is bad or IEND is missing, the
          PNM family, BMP, TGA, GIF, TIFF, WebP, DDS with BC1-BC7, FTEX,
          BLP, PSD, SGI, PCX, DCX, Sun raster, QOI, MSP, ICO, CUR, ICNS
          (JPEG 2000 entries too), XBM, XPM, JPEG 2000, FITS, FLI/FLC, IM,
          IMT, GBR, McIdas, PIXAR, SPIDER, XVThumb, IPTC, Photo CD, PIL's
          own PNM kinds and TIFF's rare kinds: BigTIFF, float, CIELab,
          LZMA, ZSTD, CCITT, old-style LZW, subsampled YCbCr) decoded by
          models/texture.decode_texture to the SHA-256 PIL gave where they
          were made (pil_rgb.json), with its ms (the WebP files', the
          arithmetic-coded JPEGs', the JPEG-in-TIFF files', the
          DDS/FTEX/BLP files', the small raster formats', the JPEG 2000
          and FITS files', the last plugin formats' and the PNM and TIFF
          rare kinds' again on a line each); the
          textured fixture with its 32x32 texture as
          a baseline 4:2:0 JPEG (utils/image.encode_jpeg; a 512-row atlas,
          K2), as an RLE TGA (the committed blob_rle.tga), as a lossy
          WebP (blob_lossy.webp), as an arithmetic-coded progressive
          JPEG (blob_arith_prog.jpg), as DXT1 (blob_bc1.dds), as a
          PackBits RGB PSD (blob_packbits.psd), as an irreversible
          (9/7, ICT) JP2 (blob_irrev.jp2) and as a line-interleaved RGB
          IM (blob_rgb.im), and cubes
          with its 256x256 texture as a
          PNG (a 32,768-row atlas, K8), with a 64x64 LZW TIFF (the
          committed cubes_lzw.tif; a 2,048-row atlas, K8), with the same
          squares as a lossless WebP (cubes_lossless.webp), in 4:2:0
          JPEG-in-TIFF tiles (cubes_jpeg_tiles.tif), as BC7
          (cubes_bc7.dds), as an RLE SGI (cubes_rle.sgi), as a
          lossless J2K in 32x32 tiles (cubes_lossless.j2k) and with 256x256
          bilevel squares as a Group 4 TIFF (cubes_g4.tif), each scene
          written by utils/demo_scene, load_scene_file -> build_scene ->
          build_render_fn at 1024x768: one
          graphed frame with exactly that path's kernels launched, held to
          the port's CPU frame (textured at 256x192, cubes at 1024x768) and
          the 1024x768 frame to the C++ oracle under the parity rule; then a
          2048x2048 seeded texture through encode_jpeg and decode_jpeg: its
          bytes, entropy symbols and decode seconds (a corpus-sized
          texture's start-up cost on the card host's CPU);
and three phases on the textured fixture:
  viewer  ViewerCore at 960x540 (the reference's window) through a scripted
          timeline 15 ms apart (idle and paused; 'w' held 10 frames; space;
          'i'; resizes to 1024x768, which grows the pad, and to 640x480,
          which does not; 'r'): each frame's shape and dtype, the sim state
          against a host replay of utils/framestate.step, five frames to the
          bit against build_render_fn(out_uint8=True) of the current state,
          one 256x192 frame against the CPU's ViewerCore on the same
          timeline, a stream_scale 2 frame against host pooling, the
          launches of one frame (the textured path's kernels, no other), and
          one capture a renderer (the resize within the pad replays);
          prints the wall ms of frame() (p50, p95 over 60 frames, 'w' held)
          and the host ms of step();
  interact
          tools/interact_bench_torch.py's main in this process at 960x540,
          --window 1.0: ViewerCore's renderer timed alone (device_frame_ms)
          and encode_jpeg on 20 frames, then viewer.run_web on port 0 on a
          thread of its own, driven over HTTP (settle, idle fps, 5 space
          presses, 'w', flying fps, a shrink within the pad and a grow past
          it, each timed until /stats shows it); checks every key of its
          JSON, platform "gpu", frames counted, each latency finite (each
          awaited state reached), the pulled frames JPEGs (FF D8 ... FF
          D9) whose SOF0 header says 960x540, and the session's GIF (their
          decodes, utils/image.write_gif), whose first frame, decoded by
          utils/raster_decode.decode_gif, is 960x540 and equals the first
          JPEG's decode quantised to the GIF's palette; prints the JSON on a
          line of its own before the kernels' line;
  octree  the octree walk (ops/octree_traverse) of a 16,384-ray fan from the
          camera over the mesh on the card: converged, against the K5 route
          (mesh_intersect_shared) and against the same walk on the CPU;
          prints its iterations and ms.
and two more on the textured and instances fixtures:
  sharded the sharded renderer (parallel/tiles.py) at 1024x768 on 4 logical
          shards of the card ([cuda:0] * 4), blocks dealt strided and
          contiguous: each frame equal to build_render_fn's to the bit, the
          aux counts equal, and its launches, counted from 0 around the frame
          after the capture (one graph of the four shards), exactly 4x a
          single frame's per kernel; the p50/p95 of the sharded
          (strided) and single frames (20 frames each); textured at 512x384,
          msaa 2 (the folded layout, render.msaa_swizzle), held under the
          parity rule to the CPU's sharded frame and to the card's per-sample
          loop frame; the mesh-hit rays per shard and their skew, strided
          against contiguous; on a host with two or more cards the frames on
          distinct cards, live and through export_sharded_render (else a
          line that says this did not run); and
          parallel.tiles.dryrun_multichip(4) on the card;
  export  utils/aot.export_render of both fixtures at 1024x768 on the card,
          saved to bytes and loaded: after the loaded program's capture, the
          loaded frames at the three states and at a second scene of the same
          shapes (other velocities and colours) replays of one graph, equal to
          the live renderer's to the bit, with a frame's launches equal to the
          live frame's, and the replayed graph holding those kernels;
          export_sharded_render on 2 logical shards (textured, 512x384)
          equal to the live sharded frame; the export tool
          tools/export_renderer_torch.py --fixture textured --device cuda
          --selfcheck run once (exit 0); every load_render runs with no
          torch.load(weights_only=False) and no fallback to one logged
          (the tool's stderr free of both); prints the export seconds, the
          bytes and the loaded frame's p50/p95.
It prints the interact phase's JSON line, the xl path's K4, K11 and K12 as a
JSON line {"xl_kernels": [...]} (the keys of the kernels' line), the
kernels' JSON line, the card's name and power limit, and as its last line
{"ok": true, "device": {...}}.
Any failed check raises.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

WIDTH, HEIGHT = 1024, 768
LEVEL = 4
DEVICE = "cuda"
INF = 1e20
PEAK_OPS = 67e12  # H100 SXM fp32 outside the tensor cores, operations/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
L2_BYTES = 50 * 2**20  # H100 L2
# fp32 operations of K3/K7 (csrc/analytic_kernels.cu): a lane's pre-test of
# one object (the transform and may_hit; K7 also forms its origin and its
# constants), and the rest of the full test on each lane of a tested warp
K3_PRETEST_OPS, K3_TEST_OPS = 40.0, 60.0
K7_PRETEST_OPS, K7_TEST_OPS = 70.0, 55.0
VIEWER_SIZE = (960, 540)  # the reference's window and the viewer CLI's default
VIEWER_GROW, VIEWER_SHRINK = (1024, 768), (640, 480)  # grows the pad; fits in it
SHARDS = 4  # shards of the sharded phase
XL_LEVELS = 4  # utils/largedemo's XL tier: bunny's 4,968 faces x 4^4
# its shapes (the JAX package's, tests/test_tpu_lowering.py): triangles,
# chunks, supers of 128, chunks of the last super, bit words a block
XL_SHAPE = (1_271_808, 39_744, 311, 64, 1_244)
STAGED_WORDS = 512  # bit words K11/K12 stage (csrc/mesh_kernels.cu kStageWordsMax)
# Paths whose frames need no occluded shadow ray. The xl mesh's triangles
# come near the reference's determinant epsilon (1e-7 in object space, in
# the kernels, the twins and native/cpu_reference.cpp alike): the stand-in's
# 4,968 faces subdivided 4 times leave about 73% of them with twice their
# area below it, so the Moller-Trumbore test rejects those at any incidence
# and most others off normal incidence, and its frames show the mesh with
# holes and no shadow on it, as the oracle's do (the bunny's share is not
# measured). K12's occlusion past the staged bit words is held on the card
# by tests/test_torch_cuda.py::test_large_walks_read_lists_past_the_staged_head.
UNSHADOWED = {"xl"}
# the interactive bench's JSON: the JAX tool's keys (tools/interact_bench.py)
# and the port's two
INTERACT_KEYS = {"scene", "size", "platform", "idle_fps", "flying_fps", "device_frame_ms",
                 "device_fps", "stream_scale", "key_latency_ms_space_p50",
                 "key_latency_ms_space_all", "key_latency_ms_w", "resize_latency_ms_first",
                 "resize_latency_ms_grow_pad", "frames_counted", "cadence_cap_fps", "device",
                 "encode_ms_p50"}
# the textures phase: the committed decode fixtures and PIL's hashes of them,
# its scenes (fixture kind, texture format, CPU parity size), and the side
# of the corpus-sized JPEG it times
TEXTURE_FIXTURES = pathlib.Path(__file__).resolve().parent / "tests" / "torch_textures"
# (a texture format utils/demo_scene writes, or a committed fixture in its place)
TEXTURE_SCENES = (("textured", "jpg", (256, 192)), ("cubes", "png", (WIDTH, HEIGHT)),
                  ("textured", "blob_rle.tga", (256, 192)),
                  ("cubes", "cubes_lzw.tif", (WIDTH, HEIGHT)),
                  ("textured", "blob_lossy.webp", (256, 192)),
                  ("cubes", "cubes_lossless.webp", (WIDTH, HEIGHT)),
                  ("textured", "blob_arith_prog.jpg", (256, 192)),
                  ("cubes", "cubes_jpeg_tiles.tif", (WIDTH, HEIGHT)),
                  ("textured", "blob_bc1.dds", (256, 192)),
                  ("cubes", "cubes_bc7.dds", (WIDTH, HEIGHT)),
                  ("textured", "blob_packbits.psd", (256, 192)),
                  ("cubes", "cubes_rle.sgi", (WIDTH, HEIGHT)),
                  ("textured", "blob_irrev.jp2", (256, 192)),
                  ("cubes", "cubes_lossless.j2k", (WIDTH, HEIGHT)),
                  ("textured", "blob_rgb.im", (256, 192)),
                  ("cubes", "cubes_g4.tif", (WIDTH, HEIGHT)))
# the small raster formats' fixtures, by suffix
LEGACY_SUFFIXES = (".psd", ".sgi", ".bw", ".rgb", ".pcx", ".dcx", ".ras", ".qoi", ".msp", ".ico",
                   ".cur", ".icns", ".xbm", ".xpm")
# the last plugin formats' fixtures (FLI/FLC, IM, IMT, GBR, McIdas, PIXAR,
# SPIDER, XVThumb, IPTC, Photo CD), and PIL's PNM kinds and TIFF's rare
# kinds (BigTIFF, float, CIELab, LZMA, ZSTD, CCITT, old-style LZW, YCbCr)
PLUGIN_SUFFIXES = (".fli", ".flc", ".im", ".imt", ".gbr", ".area", ".pxr", ".spi", ".xv", ".iim",
                   ".pcd")
RARE_FIXTURES = ("p0cmyk.pnm", "pycmyk_16bit.pnm", "pyrgba.pnm", "pyp.pnm", "float_le.pfm",
                 "float_be.pfm", "bigtiff_lzw.tif", "bigtiff_long8_tiles.tif", "float.tif",
                 "float_pred3.tif", "float_be_lzw.tif", "lab.tif", "lab_lzma.tif",
                 "lzma_pred2.tif", "ccitt_rle.tif", "g3_1d.tif", "g3_2d_fill.tif", "g4.tif",
                 "g4_wide.tif", "old_lzw.tif", "ycbcr_22_lzw.tif", "ycbcr_21_tiles.tif",
                 "ycbcr_raw.tif", "planar_palette.tif", "planar_rgba_deflate.tif",
                 "cubes_g4.tif", "zstd.tif", "zstd_pred2_strips.tif", "zstd_float.tif")
BIG_TEXTURE = 2048
PKG = "relativitypathtracer_tpu_torch/csrc/"
CSRC = pathlib.Path(__file__).resolve().parent / PKG
TPU = "relativitypathtracer_tpu/ops/pallas/"
K4_TPU = TPU + "mesh_kernels.py:389 (XLA)"
# launch-count key -> (id, source, TPU kernel it replaces)
KERNELS = {
    "rpt_shadow_chain": ("K1", PKG + "shadow_chain.cu", TPU + "shadow_chain.py:50"),
    "rpt_footprint_sample/small": ("K2", PKG + "texture_kernels.cu", TPU + "texture_kernel.py:76"),
    "rpt_analytic_nearest": ("K3", PKG + "analytic_kernels.cu", TPU + "analytic_kernels.py:308"),
    "rpt_cone_table": ("K4", PKG + "live_lists.cu", K4_TPU),
    "rpt_live_cull": ("K4", PKG + "live_lists.cu", K4_TPU),
    "rpt_bucket_order": ("K4", PKG + "live_lists.cu", K4_TPU),
    "rpt_shared_walk": ("K5", PKG + "mesh_kernels.cu", TPU + "mesh_kernels.py:514"),
    "rpt_general_walk": ("K6", PKG + "mesh_kernels.cu", TPU + "mesh_kernels.py:825"),
    "rpt_analytic_min_t": ("K7", PKG + "analytic_kernels.cu", TPU + "analytic_kernels.py:521"),
    "rpt_footprint_sample/windowed": ("K8", PKG + "texture_kernels.cu",
                                      TPU + "texture_kernel.py:226"),
    "rpt_batched_shared_walk": ("K9", PKG + "mesh_batch.cu", TPU + "mesh_batch.py:169"),
    "rpt_batched_general_walk": ("K10", PKG + "mesh_batch.cu", TPU + "mesh_batch.py:378"),
    "rpt_large_shared_walk": ("K11", PKG + "mesh_kernels.cu", TPU + "mesh_large.py:147"),
    "rpt_large_general_walk": ("K12", PKG + "mesh_kernels.cu", TPU + "mesh_large.py:338"),
}
K4 = ("rpt_cone_table", "rpt_live_cull", "rpt_bucket_order")
PATHS = {  # path -> (demo scene kind, kernels it runs, CPU parity size)
    "blob": ("blob", ("rpt_shadow_chain", "rpt_analytic_nearest", *K4, "rpt_shared_walk",
                      "rpt_general_walk"), (512, 384)),
    "textured": ("textured", ("rpt_shadow_chain", "rpt_footprint_sample/small",
                              "rpt_analytic_nearest", *K4, "rpt_shared_walk",
                              "rpt_general_walk"), (WIDTH, HEIGHT)),
    "cubes": ("cubes", ("rpt_shadow_chain", "rpt_analytic_nearest", "rpt_analytic_min_t",
                        "rpt_footprint_sample/windowed"), (WIDTH, HEIGHT)),
    "instances": ("instances", ("rpt_shadow_chain", "rpt_footprint_sample/small",
                                "rpt_analytic_nearest", *K4, "rpt_batched_shared_walk",
                                "rpt_batched_general_walk"), (512, 384)),
    "large": ("large", ("rpt_shadow_chain", "rpt_analytic_nearest", *K4,
                        "rpt_large_shared_walk", "rpt_large_general_walk"), (256, 192)),
    "xl": ("xl", ("rpt_shadow_chain", "rpt_analytic_nearest", *K4,
                  "rpt_large_shared_walk", "rpt_large_general_walk"), (128, 96)),
}
# the list function each large-tier path's large_live_lists must take
LIST_ROUTE = {"large": "live_chunk_lists2", "xl": "live_chunk_lists3"}
# launch-count key (before any "/route") -> what its kernel's name holds, as a
# graph names it (mangled) or a profiler trace does (demangled); a walk of
# K5/K6 or K11/K12 is one template fed two list kinds, and the batched walks'
# names hold the others'
TRACE_NAMES = {"rpt_shadow_chain": ("shadow_chain_kernel",),
               "rpt_footprint_sample": ("footprint_kernel",),
               "rpt_analytic_nearest": ("analytic_nearest_kernel",),
               "rpt_analytic_min_t": ("analytic_min_t_kernel",),
               "rpt_cone_table": ("cone_table_kernel",),
               "rpt_live_cull": ("live_cull",),
               "rpt_bucket_order": ("bucket_order_kernel",),
               "rpt_shared_walk": ("shared_walk_kernel", "FlatList"),
               "rpt_general_walk": ("general_walk_kernel", "FlatList"),
               "rpt_large_shared_walk": ("shared_walk_kernel", "SuperList"),
               "rpt_large_general_walk": ("general_walk_kernel", "SuperList"),
               "rpt_batched_shared_walk": ("batched_shared_walk_kernel",),
               "rpt_batched_general_walk": ("batched_general_walk_kernel",)}
# other kernels report the textured path
REPORT_FROM = {"K4": "large", "K7": "cubes", "K8": "cubes", "K9": "instances",
               "K10": "instances", "K11": "large", "K12": "large"}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def fresh(torch, a):
    """A copy of a tensor in new memory, a broadcast (stride-0) axis kept one;
    anything else as it is."""
    if not torch.is_tensor(a):
        return a
    if 0 not in a.stride():
        return a.clone()
    return a[tuple(slice(0, 1) if st == 0 else slice(None) for st in a.stride())].clone().expand(
        a.shape)


def kernel_ms(torch, fn, args, reps: int = 20) -> float:
    """Median device milliseconds of one launch of fn(*args), its inputs read
    from memory: launches captured in one CUDA graph and replayed between
    two CUDA events, so that the wrapper's host work (argument checks,
    allocation, the ctypes call) stays out of the interval; each launch reads
    its own copy of the tensor inputs (`fresh`), with copies enough (at least
    10, and together four times the L2) that none is left in L2 when its
    launch comes round again. A single call bracketed by events measures the
    host work too, which for a kernel of 10-30 us is as long as the kernel;
    replaying one set of inputs reads them from L2 where they fit in it."""
    size = nbytes(*(a for a in args if torch.is_tensor(a)))
    copies = max(10, math.ceil(4 * L2_BYTES / size))
    sets = [[fresh(torch, a) for a in args] for _ in range(copies)]
    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for one in sets:
            fn(*one)
    ms = time_ms(torch, graph.replay, reps) / copies
    del graph, sets
    return ms


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of operations over
    the fp32 peak and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (the walks also take ints),
    each element once: a broadcast (stride-0) axis counts one element."""
    return sum(math.prod(n for n, st in zip(x.shape, x.stride()) if st != 0) * x.element_size()
               for x in tensors if hasattr(x, "stride"))


def same(torch, got, want) -> bool:
    """Equal to the bit (floats as their int32 bits; None only to None)."""
    if got is None or want is None:
        return got is None and want is None
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return torch.equal(got, want)


def max_err(got, want) -> float:
    return max((float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)
                if g is not None and g.numel()), default=0.0)


def list_bound_ms(args, kwargs, out, tests) -> float:
    """The least time of one list build: its spheres, rays and lane masks
    read once and its lists written once over the memory rate, or 30
    operations a cone test its culls ran (`cull_work`) and 40 a (block,
    entry) of the sort over the fp32 rate, the larger."""
    moved = nbytes(*args, *kwargs.values(), *out)
    return bound(30.0 * tests + 40.0 * out[0].numel(), moved)[0]


def cull_work(torch, mk, fn, args):
    """One more run of a cull (outside any timed run) with its group
    pre-test's skip counter, held equal to the count of the pre-test's plain
    form (group_may_overlap_plain): (cone tests it ran, groups skipped,
    (block, 32-chunk group) pairs). Every pair runs the pre-test's `sub`
    cone tests (a pool group across two objects counts as pre-tested) and
    every pair not skipped the dense `sub` a real chunk of its group (a
    ragged last group has fewer). The dense work, every (cone, chunk) test,
    is `sub` a (block, chunk) pair."""
    spheres, table, sub = args[:3]
    use_bound = args[3] if len(args) > 3 else False
    cobj = args[4] if len(args) > 4 else None
    skipped = torch.zeros(1, dtype=torch.int32, device=spheres.device)
    fn(*args, skipped=skipped)
    may = mk.group_may_overlap_plain(spheres, table, sub, use_bound, cobj)
    real = (spheres.shape[0] - 32 * torch.arange(may.shape[1], device=may.device)).clamp(max=32)
    pairs, n = may.numel(), int(skipped)
    check(n == pairs - int(may.sum()), f"the cull skipped {n} groups, its plain pre-test "
          f"{pairs - int(may.sum())}")
    return sub * (pairs + int((may * real).sum())), n, pairs


def cull_launches(torch, mk, fn, args, kwargs):
    """The cull launches of one list build: [(device ms a launch, groups
    skipped, (block, 32-chunk group) pairs, cone tests run)]."""
    real, seen = mk.live_cull, []

    def counted(*a):
        seen.append(a)
        return real(*a)

    mk.live_cull = counted
    try:
        fn(*args, **kwargs)
    finally:
        mk.live_cull = real
    out = []
    for a in seen:
        tests, n, pairs = cull_work(torch, mk, real, a)
        out.append((kernel_ms(torch, real, list(a)), n, pairs, tests))
    return out


def compare_lists(torch, mk, path, calls, plains):
    """Every list build of the first frame (its list function, captured
    with its inputs) against the same function on K4's twins: equal to the
    bit; K4's device ms a frame (each build replayed from a CUDA graph, as
    kernel_ms times a kernel) against the twins' ms a frame (CUDA events
    around a call), and the bound; each build's cull launches with their
    ms and the share of groups the pre-test skipped (large fails if its
    culls skip none, xl if one of them does: the pre-test runs in the
    super-sphere cull and in the bits pass of one cone a block alike)."""
    builds, k_ms, p_ms, b_ms, culls = {}, 0.0, 0.0, 0.0, []
    for name, fn, args, kwargs in calls:
        plain = plains[name]
        got, want = fn(*args, **kwargs), plain(*args, **kwargs)
        for part, g, w in zip(("order", "floors", "counts", "bits"), got, want):
            check(same(torch, g, w), f"K4 on {path}: {name} {part} differ from the twin's")
        keys = list(kwargs)
        k_ms += kernel_ms(torch, lambda *a, _fn=fn, _n=len(args), _k=keys: _fn(
            *a[:_n], **dict(zip(_k, a[_n:]))), [*args, *kwargs.values()])
        p_ms += time_ms(torch, lambda: plain(*args, **kwargs))
        launches = cull_launches(torch, mk, fn, args, kwargs)
        b_ms += list_bound_ms(args, kwargs, got, sum(c[3] for c in launches))
        builds[name] = builds.get(name, 0) + 1
        culls += launches
    check(builds, f"K4 on {path}: no list build captured")
    skipped = sum(c[1] for c in culls)
    check(path != "large" or skipped > 0, f"K4 on {path}: the cull's pre-test skipped no group")
    check(path != "xl" or all(c[1] > 0 for c in culls),
          f"K4 on {path}: a cull's pre-test skipped no group")
    log(f"  K4 on {path}: {sum(builds.values())} list builds a frame {builds}, equal to the "
        f"twins' to the bit; kernels {k_ms:.4f} ms a frame (table, cull and sort), twins "
        f"{p_ms:.4f} ms, bound {b_ms:.4f} ms, share {b_ms / k_ms:.1%}; the cull a launch: "
        + ", ".join(f"{ms:.4f} ms (pre-test skipped {n:,} of {pairs:,} groups, {n / pairs:.2%})"
                    for ms, n, pairs, _ in culls))


def compare_kernels(torch, pt_mods, meta, captured, originals, names, path):
    """Each kernel of `names` against its plain twin on its captured
    first-frame inputs: checks, error, kernel/plain ms, bound. A mesh
    walk's twin runs once, its walk count on: the kernel is held to that
    run's result, and its time is the plain ms (a median of 20 runs for the
    other kernels)."""
    ak, mk, sc, tk, mb, ml = pt_mods
    out = {}

    def record(name, err, fn, args, plain, ops, moved, library=None):
        """`plain`: the twin, timed here, or the ms of its run."""
        b_ms, b_by = bound(ops, moved)
        plain_ms = plain if isinstance(plain, float) else time_ms(torch, lambda: plain(*args))
        out[name] = {"max_abs_err": err, "ms": kernel_ms(torch, fn, args),
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library}
        log(f"  {name}: max_abs_err {err:.3e}, kernel {out[name]['ms']:.4f} ms (one wrapper "
            f"call {time_ms(torch, lambda: fn(*args)):.4f} ms), plain "
            f"{out[name]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
            f"{b_ms / out[name]['ms']:.1%}" + ("" if library is None else
                                               f", library {library:.4f} ms"))

    for name in names:
        args = captured[name]
        fn = originals[name]
        if name == "rpt_shadow_chain":
            got, want = fn(*args), sc.shadow_chain_plain(*args)
            light = meta.light_ids[0]
            relevant = (args[3] < INF) & (args[5] != light) & (want[2] > 0)
            check(int(relevant.sum()) > 0, "K1: no relevant lanes")
            err = 0.0
            for g, w in zip(got, want):
                check(torch.allclose(g[..., relevant], w[..., relevant], rtol=1e-5, atol=1e-6),
                      "K1 disagrees with its twin")
                err = max(err, float((g[..., relevant] - w[..., relevant]).abs().max()))
            n = args[2].shape[1]
            record(name, err, fn, args, sc.shadow_chain_plain, 150.0 * n,
                   nbytes(*args[:6]) + 40 * n)
        elif name in ("rpt_live_cull", "rpt_bucket_order"):
            cull = name == "rpt_live_cull"
            plain = mk.live_cull_plain if cull else mk.bucket_order_plain
            got, want = fn(*args), plain(*args)
            check(all(same(torch, g, w) for g, w in zip(got, want)),
                  f"K4 {name} differs from its twin")
            # the cull: 30 operations a cone test it ran; the sort: 40 an entry
            work = cull_work(torch, mk, fn, args)[0] if cull else args[0].numel()
            moved = nbytes(*args, *(g for g in got if g is not None))
            library = None
            if not cull:  # the one PyTorch call that gives the sort's permutation
                bk, _, _ = mk.bucket_ids_plain(*args)
                ids = torch.where(args[1], bk, mk.NBKT)
                check(torch.equal(torch.sort(ids, dim=1, stable=True)[1].int(), want[0]),
                      "K4 sort: torch.sort's permutation differs from the twin's")
                library = kernel_ms(torch, lambda x: torch.sort(x, dim=1, stable=True), [ids])
            record(name, max_err(got, want), fn, args, plain, (30.0 if cull else 40.0) * work,
                   moved, library)
            if cull:
                dense = args[1].shape[-2] * args[0].shape[0]
                log(f"  rpt_live_cull: {work:,} cone tests run of {dense:,}; the bound of "
                    f"every test {bound(30.0 * dense, moved)[0]:.4f} ms")
        elif name == "rpt_cone_table":
            got, want = fn(*args), mk.cone_table_plain(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            check(all(same(torch, g, w) for g, w in zip(got, want)),
                  "K4 rpt_cone_table differs from its twin")
            d, lanes = args[0], args[4] if len(args) > 4 else mk.SUB_LANES
            rows = got[0]
            # about 30 operations a lane and object; the rays, the mask, the
            # lane bound and the scales read once (a broadcast origin once),
            # the rows and smin written once
            record(name, max_err(got, want), fn, args, mk.cone_table_plain,
                   30.0 * d.numel() / 3, nbytes(*args, *got))
            log(f"  rpt_cone_table: {rows.shape[-2]:,} {lanes}-lane groups"
                f"{'' if d.dim() == 2 else f' x {d.shape[0]} objects'}, origin "
                f"{'broadcast' if 0 in args[1].stride() else 'per lane'}")
        elif name == "rpt_analytic_nearest":
            gt, gn, guv, go = fn(*args)
            wt, wn, wuv, wo = ak.analytic_nearest_plain(*args)
            # Same fp32 operations in the same order: t, normal and object id
            # bit for bit; the spherical uv within 1e-5 (CUDA's atan2f/asinf
            # and PyTorch's differ in the last bits).
            check(torch.equal(gt, wt) and torch.equal(gn, wn) and torch.equal(go, wo),
                  "K3 t, normal or object id differ from its twin")
            hit = wt < INF
            check(int(hit.sum()) > 0, "K3: no hits")
            err = float((guv - wuv)[:, hit].abs().max())
            check(err <= 1e-5, f"K3 uv off its twin by {err}")
            n, G = args[1].shape[1], args[0].shape[0]
            tested = analytic_votes(torch, ak, "K3", path, fn, args, None)
            # every lane's pre-test, and the full test on the 32 lanes of
            # each (warp, object) pair whose vote ran it
            record(name, err, fn, args, ak.analytic_nearest_plain,
                   K3_PRETEST_OPS * G * n + K3_TEST_OPS * 32 * tested,
                   nbytes(args[0], args[1]) + 28 * n)
        elif name in ("rpt_shared_walk", "rpt_large_shared_walk", "rpt_batched_shared_walk"):
            batched = name == "rpt_batched_shared_walk"
            walked, live, twin, twin_ms = shared_walk_counts(torch, mk, ml, mb, name, args)
            got, want = fn(*args), twin
            kid = KERNELS[name][0]
            check(int((want[3] >= 0).sum()) > 0, f"{kid}: no hits")
            parts = ("t", "u", "v", "triangle ids", *(("object slots",) if batched else ()),
                     "attributes")
            for part, g, w in zip(parts, got, want):
                check(bool(torch.equal(g, w)), f"{kid} {part} differ from its twin")
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            # every lane of a walking block is tested: 32 triangles x 1,024
            # lanes a chunk, 29 operations a test (K9: one more, the scale);
            # the walked chunks where the walk stops short of the lists by
            # more than 5%
            chunks = float(walked.sum() if walked.sum() < 0.95 * live.sum() else live.sum())
            n = args[-1].shape[1] if batched else args[7 if name == "rpt_large_shared_walk"
                                                        else 6].shape[1]
            record(name, err, fn, args, twin_ms, (30.0 if batched else 29.0) * 32 * 1024 * chunks,
                   nbytes(*args) + (80 if batched else 76) * n)
        elif name.startswith("rpt_footprint_sample/"):
            # the frame's form: the fetch with the flat-colour select
            check(len(args) == 6, f"{name}: called without the flat colours")
            (got, gq), (want, wq) = fn(*args, with_quads=True), tk.footprint_fetch_plain(*args)
            check(bool(torch.equal(gq, wq)), f"{name}: the kernel read other atlas rows")
            err = float((got - want).abs().max())
            check(same(torch, got, want), f"{name}: hit colour differs from its twin by {err}")
            tex = args[5][args[2].long()]
            check(bool(tex.any()) and bool((~tex).any()),
                  f"{name}: no textured or no untextured lane")
            n = args[3].shape[1]
            log(f"  {name}: {int(tex.sum()):,} textured and {int((~tex).sum()):,} untextured "
                f"lanes, equal to the twin to the bit")
            # about 150 integer and fp32 operations a lane (the address, 12
            # channel values, the weights); the lanes' ids and uv read and
            # RGB written once, the atlas and the object rows once
            record(name, err, fn, args, tk.footprint_fetch_plain, 150.0 * n,
                   nbytes(*args) + 12 * n)
        elif name == "rpt_analytic_min_t":
            got, want = fn(*args), ak.analytic_min_t_plain(*args)
            tmax = args[5]
            rel = tmax > 0
            check(int(rel.sum()) > 0, "K7: no shadow lanes")
            check(bool(torch.equal((got >= tmax)[rel], (want >= tmax)[rel])), "K7 lit masks")
            occ = rel & (want < tmax)
            check(int(occ.sum()) > 0, "K7: no occluded lanes")
            err = float((got - want).abs().max())
            check(same(torch, got, want), f"K7 differs from its twin (max abs err {err})")
            n, G, active = tmax.shape[0], args[0].shape[0], int((tmax != 0).sum())
            tested = analytic_votes(torch, ak, "K7", path, fn, args, args[1])
            # o4 and dir4 read only on lanes with tmax != 0; tmax read and t
            # written on every lane; the pre-test on the active lanes
            moved = nbytes(args[0]) + 32 * active + 8 * n
            record(name, err, fn, args, ak.analytic_min_t_plain,
                   K7_PRETEST_OPS * G * active + K7_TEST_OPS * 32 * tested, moved)
            every = nbytes(args[0], args[1], args[2], tmax) + 4 * n
            log(f"  rpt_analytic_min_t: the bound counting o4 and dir4 on every lane and 100 "
                f"operations a lane and object with tmax > 0 (the earlier count) "
                f"{bound(100.0 * G * float(rel.sum()), every)[0]:.4f} ms")
        elif name in ("rpt_general_walk", "rpt_batched_general_walk", "rpt_large_general_walk"):
            batched = name == "rpt_batched_general_walk"
            tmax = args[9] if batched else args[6 if name == "rpt_general_walk" else 7][0]
            masked = tmax > 0
            walked, lanes, live, twin, twin_ms = walked_tests(torch, mk, ml, mb, name, args,
                                                              masked)
            got, want = fn(*args), twin
            kid = KERNELS[name][0]
            check(int(masked.sum()) > 0, f"{kid}: no shadow lanes")
            check(bool(torch.equal((got >= tmax)[masked], (want >= tmax)[masked])),
                   f"{kid} lit masks")
            check(path in UNSHADOWED or int((want < tmax)[masked].sum()) > 0,
                  f"{kid}: no occluded lanes")
            check(bool(torch.equal(got, want)), f"{kid} differs from its twin")
            # 32 triangles a chunk x the block's lanes with tmax > 0 (a lane
            # with tmax == 0 needs no test: its result is min(bt, 0)), 47
            # operations a test (K10: one more, the scale); the live chunks,
            # or the walked ones where the walks stop short of the lists by
            # more than 5%
            live = float((live.double() * lanes).sum()) * 32
            walked = float((walked.double() * lanes).sum()) * 32
            tests = walked if walked < 0.95 * live else live
            record(name, float((got - want).abs().max()), fn, args, twin_ms,
                   (48.0 if batched else 47.0) * tests, nbytes(*args) + 4 * tmax.shape[0])
    return out


def analytic_votes(torch, ak, kid, path, fn, args, origins4) -> int:
    """K3/K7: one more run (outside any timed run) with the kernel's
    `tested` counter: the (warp, object) pairs whose vote ran the full test.
    It must equal the count of the pre-test's plain form
    (object_may_hit_plain, lanes with tmax == 0 voting no); prints the share
    of pairs skipped. Returns the pairs tested."""
    tested = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    fn(*args, tested=tested)
    tested = int(tested)
    params, dir4 = args[0], args[2 if origins4 is not None else 1]
    ns, nc = args[3 if origins4 is not None else 2], args[4 if origins4 is not None else 3]
    may = ak.object_may_hit_plain(params, dir4, ns, nc, origins4)
    if origins4 is not None:
        may = may & (args[5] != 0)
    want = ak.warp_votes_plain(may)
    pairs = may.shape[0] * -(-may.shape[1] // ak.WARP)
    check(tested == want, f"{kid} on {path}: {tested} pairs tested, the plain pre-test {want}")
    check(path != "cubes" or tested < pairs, f"{kid} on {path}: the vote skipped no object")
    log(f"  {kid} on {path}: the vote ran {tested:,} of {pairs:,} (warp, object) full tests, "
        f"skipped {1 - tested / pairs:.2%}, as the plain pre-test counts")
    return tested


def switches_note(mb, name, args, walked) -> str:
    """K9/K10: how often the blocks' walks change object, from one walked
    chunk to the next (each change is a switch of the per-object rays a
    walk reads); empty for the one-mesh walks."""
    if not name.startswith("rpt_batched"):
        return ""
    sw = mb.object_switches(args[0], args[3], walked)
    return (f"; object switches {int(sw.sum())} in {int(walked.sum())} walked chunks (most "
            f"{int(sw.max())} in one block, {int((sw > 0).sum())} blocks switch)")


def timed_twin(torch, fn):
    """fn() once between two CUDA events, synchronized: (its result, ms)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def twin_lists(ml, name, args):
    """The lists a one-mesh walk's twin walks, the rest of its arguments and
    T: the flat list with each chunk's floor (K5, K6), or the superchunk
    cursor written out (K11, K12)."""
    if name in ("rpt_shared_walk", "rpt_general_walk"):
        order, minds, counts = args[:3]
        return (order, minds.gather(1, order.long()), counts), args[3:7], None
    return ml.super_cursor_lists(*args[:4], args[8], args[9]), args[4:8], args[10]


def cursor_note(torch, name, args, lists, walked) -> str:
    """K11/K12: the fullest block's live supers, the bit rows' width, and the
    furthest bit word a walk reached (that of the last chunk a block
    walked), against the words the kernels stage; empty for the others."""
    if not name.startswith("rpt_large"):
        return ""
    chunks = lists[0]
    last = chunks.gather(1, (walked.clamp(min=1) - 1)[:, None]).long()[:, 0]
    word = int(torch.where(walked > 0, last // 32, -1).max())
    return (f"; supers of {args[8]}, {int(args[2].max())} live in the fullest block's list, "
            f"bit rows {args[3].shape[1]:,} words, the furthest bit word a walk reached {word:,} "
            f"({'past' if word >= STAGED_WORDS else 'within'} the {STAGED_WORDS} staged)")


def walked_tests(torch, mk, ml, mb, name, args, active):
    """K6/K12/K10: the chunks each block walks (the twin's walk with its
    count on, timed; the kernel walks the same ones), and the ray/triangle
    tests of a walk that tests every lane of a walking block (the design
    before the shadow walks' redesign) against those of one that tests only
    the lanes with tmax > 0 (the kernel's). Returns ((B,) walked, (B,)
    active lanes, (B,) live chunks of the lists, the twin's result, its
    ms)."""
    if name == "rpt_batched_general_walk":
        (twin, walked), ms = timed_twin(torch, lambda: mb.batched_general_walk_plain(
            *args, walked=True))
        live, lists = args[2], None
    else:
        def run():
            lists, rest, T = twin_lists(ml, name, args)
            return lists, mk.walk_general_lists(*lists, *rest, T, walked=True)

        (lists, (twin, walked)), ms = timed_twin(torch, run)
        live = lists[2]
    lanes = active.reshape(-1, 1024).sum(dim=1)
    per_block = walked * lanes
    every, only = 32 * 1024 * int(walked.sum()), 32 * int(per_block.sum())
    top = int(per_block.argmax())
    log(f"  {KERNELS[name][0]} walk: {int(walked.sum())} chunks walked of "
        f"{int(live.sum())} live by "
        f"{int((walked > 0).sum())} of {walked.numel()} blocks (most {int(walked.max())}), "
        f"{int(active.sum())} active lanes, {int(lanes[walked > 0].sum())} of them in walking "
        f"blocks; tests: every lane of a walking block {every:,}, active lanes only {only:,} "
        f"({every / max(only, 1):.1f}x fewer); the block with most tests walks "
        f"{int(walked[top])} chunks with {int(lanes[top])} active lanes "
        f"({int(per_block[top]) / max(int(per_block.sum()), 1):.1%} of the tests)"
        + switches_note(mb, name, args, walked) + cursor_note(torch, name, args, lists, walked))
    return walked, lanes, live, twin, ms


def shared_walk_counts(torch, mk, ml, mb, name, args):
    """K5/K11/K9: the chunks each block walks (the twin's walk with its
    count on, timed; the kernel walks the same ones) against the live chunks
    of its list. Every lane of a walking block is tested, so a block's tests
    are its walked chunks x 32 x 1,024. Returns ((B,) walked, (B,) live, the
    twin's result, its ms)."""
    if name == "rpt_batched_shared_walk":
        (*twin, walked), ms = timed_twin(torch, lambda: mb.batched_shared_walk_plain(
            *args, walked=True))
        live, lists = args[2].long(), None
    else:
        def run():
            lists, rest, T = twin_lists(ml, name, args)
            return lists, mk.walk_shared_lists(*lists, *rest, T, walked=True)

        (lists, (*twin, walked)), ms = timed_twin(torch, run)
        live = lists[2].long()
    top = int(walked.argmax())
    log(f"  {KERNELS[name][0]} walk: {int(walked.sum())} chunks walked of {int(live.sum())} "
        f"live in the lists ({int(walked.sum()) / max(int(live.sum()), 1):.1%}), by "
        f"{int((walked > 0).sum())} of {walked.numel()} blocks (most {int(walked[top])}, of "
        f"{int(live[top])} live in that block's list); the heaviest block holds "
        f"{int(walked[top]) / max(int(walked.sum()), 1):.1%} of the tests"
        + switches_note(mb, name, args, walked) + cursor_note(torch, name, args, lists, walked))
    return walked, live, tuple(twin), ms


def parity(torch, pt, host, state, card_img, card_aux, size, msaa=1):
    """Render `state` with the port on the CPU at `size` and hold the card's
    image to it under the parity rule."""
    t0 = time.perf_counter()
    cpu_scene, cpu_meta = pt.build_scene(host, device="cpu")
    cpu_render = pt.build_render_fn(cpu_meta, size[0], size[1], -1, msaa, with_aux=True,
                                    device="cpu")
    cpu_img, cpu_aux = cpu_render(cpu_scene, pt.FrameState(state.cam_velocity.cpu(),
                                                           state.cam_pos.cpu()))
    diff = (card_img.cpu() - cpu_img).abs().amax(dim=-1)
    frac_bad = float((diff > 1e-3).float().mean())
    log(f"  card vs CPU frame at {size[0]}x{size[1]}, msaa {msaa}: frac_bad {frac_bad:.6f}, "
        f"max diff {float(diff.max()):.3e}; CPU {time.perf_counter() - t0:.1f} s, card counts "
        f"{({k: int(v) for k, v in card_aux.items()})}, CPU counts "
        f"{({k: int(v) for k, v in cpu_aux.items()})}")
    check(frac_bad <= 0.002, f"card frame off the CPU frame on {frac_bad:.4%} of pixels")


def frame_time(torch, render, scene, state, card):
    from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms

    torch.cuda.reset_peak_memory_stats()  # the peak below is this path's frames'
    times = cuda_frame_times_ms(render, scene, state, frames=60, warmup=5)
    _, aux = render(scene, state)
    p50, p95 = times[len(times) // 2], times[int(0.95 * (len(times) - 1))]
    rays = WIDTH * HEIGHT + int(aux["shadow_rays"])
    log(f"  frame {WIDTH}x{HEIGHT} on {card}: p50 {p50:.3f} ms, p95 {p95:.3f} ms, "
        f"{rays / (p50 * 1e3):.2f} Mrays/s ({rays} rays: primary + {int(aux['shadow_rays'])}"
        f" shadow), peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")


def oracle_check(torch, path, scene, meta, state, card_img, card):
    """The card's 1024x768 frame of `state` against the C++ oracle's image of
    the port's scene blob at that state (utils/parity: the oracle compiled
    from native/cpu_reference.cpp into build/oracle/), under the parity
    rule; the oracle's p50 over 3 frames, on the card host's CPU."""
    from relativitypathtracer_tpu_torch.utils import parity as par

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref, stats = par.run_oracle(scene, meta, state, WIDTH, HEIGHT, tmp, path, -1, frames=3)
    res = par.compare(card_img.cpu().numpy(), ref)
    log(f"  oracle on {path} at {WIDTH}x{HEIGHT}: frac_bad {res['frac_bad']:.6f}, mean_diff "
        f"{res['mean_diff']:.3e} (card {card}); the oracle p50 {stats['p50_ms']:.1f} ms on the "
        f"card host's CPU ({stats['threads']} threads), {time.perf_counter() - t0:.1f} s with "
        f"the blob")
    check(res["ok"], f"{path}: card frame off the oracle on {res['frac_bad']:.4%} of pixels")


def xl_source(largedemo, workdir: str) -> tuple[str, str]:
    """The OBJ the xl path subdivides: the reference's bunny where it exists
    (largedemo.SRC_OBJ, under $REF_ASSETS), else its stand-in written under
    `workdir` (named bunny_stand_in.obj, so that its scene and pickle are
    never taken for the bunny's). Returns (path, what it is)."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import write_bunny_stand_in

    if os.path.isfile(largedemo.SRC_OBJ):
        return largedemo.SRC_OBJ, "the reference's bunny"
    return (write_bunny_stand_in(os.path.join(workdir, "stand_in", "bunny_stand_in.obj")),
            "bunny's stand-in (utils/demo_scene.write_bunny_stand_in)")


def largedemo_phase(largedemo, workdir: str, src: str, card: str) -> None:
    """utils/largedemo.large_parity_and_time at 1024x768 at levels 4 (its
    scene read from the pickle the xl path's build wrote in `workdir`) and
    at levels 3 (built afresh): each ok under the parity rule against the
    oracle, on the card, with the triangle count of bunny's 4,968 faces x
    4^levels; prints its JSON and bench.py's line for it."""
    from relativitypathtracer_tpu_torch.utils.demo_scene import BUNNY_FACES

    for levels, what in ((XL_LEVELS, "XL mesh"), (3, "large mesh")):
        cached = os.path.exists(largedemo.xl_cache_path(levels, workdir, src))
        t0 = time.perf_counter()
        res = largedemo.large_parity_and_time(WIDTH, HEIGHT, workdir=workdir, levels=levels,
                                              device=DEVICE, src_obj=src)
        log(f"  {json.dumps(res)}")
        log(f"  {what} ({res['tris']} tris): {res['frame_ms']:.1f} ms/frame, frac>1e-3 = "
            f"{res['frac_bad']:.5f} (ok={res['ok']}) on {card}; large_parity_and_time "
            f"{time.perf_counter() - t0:.1f} s, its scene from "
            f"{'the pickle' if cached else 'a fresh build'}")
        check(res["ok"] and res["tris"] == BUNNY_FACES * 4 ** levels
              and math.isfinite(res["frame_ms"]) and res["frame_ms"] > 0,
              f"largedemo at levels {levels}: {res}")


def viewer_phase(torch, pt, host, dev, card, static_launches, static_frames):
    """ViewerCore on the textured fixture at 960x540 through a scripted
    timeline with synthetic times 15 ms apart; see the module docstring.
    One frame's launches must equal a static frame's on the same path:
    static_launches over static_frames frames."""
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.render import TILE, _round_up
    from relativitypathtracer_tpu_torch.utils.framestate import SimState, step
    from relativitypathtracer_tpu_torch.utils.timing import percentile
    from relativitypathtracer_tpu_torch.viewer import KEY_CHARS, ViewerCore

    (vw, vh), grow = VIEWER_SIZE, VIEWER_GROW
    t0 = time.perf_counter()
    core = ViewerCore(host, vw, vh, device=dev)
    check(not core.stats()["compiling"] and len(core._renders) == 2,
          f"viewer: renderers after start-up {list(core._renders)}")
    log(f"  viewer: ViewerCore {vw}x{vh} built and warmed in {time.perf_counter() - t0:.1f} s, "
        f"renderers {list(core._renders)}")

    def static(c):
        st = pt.FrameState(c.sim.frame.cam_velocity.to(dev), c.sim.frame.cam_pos.to(dev))
        return pt.build_render_fn(c.meta, c.width, c.height, c.sim.interval, out_uint8=True,
                                  device=dev)(c.scene, st).cpu().numpy()[::-1]

    # (held keys, resize request, marked): marked frames are held to the
    # static renderer of the current state to the bit
    timeline = ([(set(), None, False), (set(), None, True)]
                + [({"w"}, None, k == 9) for k in range(10)]
                + [({" "}, None, False), (set(), None, False), (set(), None, False)]
                + [({"i"}, None, True)]
                + [(set(), VIEWER_GROW, True), (set(), VIEWER_SHRINK, True)]
                + [({"r"}, None, False)])
    replay = SimState.initial(core.meta.default_interval, device="cpu")
    prev_t, speeds, marked = None, [], 0
    for n, (keys, resize, mark) in enumerate(timeline):
        now = n * 0.015
        if resize is not None:
            core.request_resize(*resize)
        if n == 5:  # one frame's launches, 'w' held, interval -1
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
        img = core.frame(keys, now_s=now)
        if n == 5:
            launches = dict(_build.LAUNCHES)
            per_frame = {k: v / static_frames for k, v in static_launches.items()}
            check(launches == per_frame,
                  f"viewer frame launches {launches}, a static frame's {per_frame}")
            log(f"  viewer: one frame's launches {launches}")
        frame_ms = 0.0 if prev_t is None else max(0.0, (now - prev_t) * 1e3)
        prev_t = now
        replay = step(replay, [c in keys for c in KEY_CHARS], frame_ms)
        for got, want in ((core.sim.frame.cam_velocity, replay.frame.cam_velocity),
                          (core.sim.frame.cam_pos, replay.frame.cam_pos)):
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"viewer frame {n}: sim state off the host replay")
        check((core.sim.paused, core.sim.interval) == (replay.paused, replay.interval),
              f"viewer frame {n}: toggles off the host replay")
        check(img.shape == (core.height, core.width, 3) and img.dtype == np.uint8,
              f"viewer frame {n}: {img.shape} {img.dtype}")
        speeds.append(float(np.linalg.norm(core.sim.frame.cam_velocity.numpy())))
        if mark:
            check(np.array_equal(img, static(core)),
                  f"viewer frame {n}: not the static renderer's frame of its state")
            marked += 1
        if n == 12:
            t_space = float(core.sim.frame.cam_pos[0])
    pos = [float(x) for x in core.sim.frame.cam_pos]
    check(marked == 5, "viewer: five marked frames")
    check(pos[0] > t_space, f"viewer: time {pos[0]} did not advance after space")
    check(all(b > a for a, b in zip(speeds[1:12], speeds[2:12])), f"speed {speeds[1:12]}")
    check(core.sim.interval == 0 and not core.sim.paused and speeds[-1] == 0.0,
          f"viewer end state {core.stats()}")
    check(core._pad == (_round_up(grow[1], TILE), _round_up(grow[0], TILE))
          and (core.width, core.height) == VIEWER_SHRINK
          and len(core._renders) == 3, f"viewer pad {core._pad}, {list(core._renders)}")
    # one capture a renderer: the shrink within the grown pad copied new
    # dirs into the same graph
    check(all(r.captures == 1 for r in core._renders.values()),
          f"viewer captures {[r.captures for r in core._renders.values()]}")
    log(f"  viewer: {len(timeline)} frames of the timeline, sim state equal to the host "
        f"replay, 5 frames equal to the static renderer's to the bit; speed "
        f"{speeds[2]:.4f} -> {speeds[11]:.4f}c, time {pos[0]:.3f} s, pad {core._pad}")

    # one frame against the CPU's ViewerCore at 256x192 on the same timeline
    short = [(set(), 0.0), ({"w"}, 0.015), ({"w", " "}, 0.030), ({"w"}, 0.045)]
    small, cpu = ViewerCore(host, 256, 192, device=dev), ViewerCore(host, 256, 192, device="cpu")
    for keys, now in short:
        a, b = small.frame(keys, now_s=now), cpu.frame(keys, now_s=now)
    off = float((np.abs(a.astype(np.int16) - b.astype(np.int16)).max(axis=-1) > 1).mean())
    log(f"  viewer: 256x192 frame against the CPU's ViewerCore: {off:.4%} of pixels off by "
        f"more than 1 lsb")
    check(off <= 0.002, "viewer: card frame off the CPU's")

    # stream_scale 2 against host pooling of the static frame
    pooled = ViewerCore(host, vw, vh, stream_scale=2, device=dev)
    b = pooled.frame(set(), now_s=0.0).astype(np.float32)
    full = static(pooled).astype(np.float32).reshape(vh // 2, 2, vw // 2, 2, 3).mean((1, 3))
    err = float(np.abs(full - b).max())
    check(b.shape == (vh // 2, vw // 2, 3) and err <= 1.5, f"stream_scale 2: {b.shape}, {err} lsb")
    log(f"  viewer: stream_scale 2 frame {b.shape}, within {err} lsb of host pooling")

    # wall ms of frame() at the window's size, interval -1, 'w' held
    core, walls = ViewerCore(host, vw, vh, device=dev), []
    for n in range(65):
        t0 = time.perf_counter()
        core.frame({"w"}, now_s=n * 0.015)
        if n >= 5:
            walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    sim, steps = SimState.initial(-1, device="cpu"), []
    for n in range(1000):
        t0 = time.perf_counter()
        sim = step(sim, [n % 3 == 0] + [False] * 8, 15.0)
        steps.append((time.perf_counter() - t0) * 1e3)
    steps.sort()
    log(f"  viewer: frame() wall at {core.width}x{core.height} on {card}: p50 "
        f"{percentile(walls, 50):.3f} ms, p95 {percentile(walls, 95):.3f} ms (60 frames, "
        f"'w' held; render, fetch, crop); step() on the host p50 {percentile(steps, 50):.4f} ms")


def jpeg_size(data: bytes):
    """(width, height) from a baseline JPEG's SOF0 header."""
    i = 2
    while i + 4 <= len(data) and data[i] == 0xFF:
        marker, length = data[i + 1], int.from_bytes(data[i + 2:i + 4], "big")
        if marker == 0xC0:
            return (int.from_bytes(data[i + 7:i + 9], "big"),
                    int.from_bytes(data[i + 5:i + 7], "big"))
        i += 2 + length
    return None


def interact_phase(card) -> dict:
    """tools/interact_bench_torch.py's main in this process on the textured
    fixture at 960x540, --window 1.0: the web viewer over HTTP on the card;
    see the module docstring. Returns its JSON."""
    import importlib.util

    root = pathlib.Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "interact_bench_torch", root / "tools" / "interact_bench_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    (vw, vh), out = VIEWER_SIZE, root / "build" / "interact_smoke"
    rc = tool.main(["--scene", "textured", "--size", f"{vw}x{vh}", "--window", "1.0",
                    "--out", str(out)])
    check(rc == 0, f"interact: the bench exited {rc}")
    res = json.loads((out / "interact.json").read_text())
    check(set(res) == INTERACT_KEYS, f"interact: keys {sorted(set(res) ^ INTERACT_KEYS)}")
    check(res["platform"] == "gpu" and res["size"] == [vw, vh] and res["frames_counted"] > 0,
          f"interact: {res}")
    latencies = [res["key_latency_ms_space_p50"], *res["key_latency_ms_space_all"],
                 res["key_latency_ms_w"], res["resize_latency_ms_first"],
                 res["resize_latency_ms_grow_pad"]]
    # the bench raises unless each awaited state (a pause flip, a speed, each
    # resize's size) was reached, so a latency here is a reached one
    check(len(latencies) == 9 and all(math.isfinite(x) and x >= 0 for x in latencies),
          f"interact: latencies {latencies}")
    check(all(math.isfinite(res[k]) and res[k] > 0 for k in
              ("idle_fps", "flying_fps", "device_frame_ms", "encode_ms_p50")), f"interact: {res}")
    jpegs = sorted(out.glob("frame_*.jpg"))
    check(len(jpegs) > 0, "interact: no frames pulled")
    for path in jpegs:
        data = path.read_bytes()
        check(data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
              and jpeg_size(data) == (vw, vh), f"interact: {path.name} is not a {vw}x{vh} JPEG")
    from relativitypathtracer_tpu_torch.utils.image import PALETTE, quantize
    from relativitypathtracer_tpu_torch.utils.image_decode import decode_jpeg
    from relativitypathtracer_tpu_torch.utils.raster_decode import decode_gif

    gif = out / "session.gif"
    check(gif.is_file(), "interact: no session.gif")
    first = decode_gif(gif.read_bytes())
    check(first.shape == (vh, vw, 3) and np.array_equal(
        first, PALETTE[quantize(decode_jpeg(jpegs[0].read_bytes()))]),
        f"interact: session.gif's first frame {first.shape} is not the first pulled frame's")
    log(f"  interact: session.gif ({gif.stat().st_size} bytes), its first frame {vw}x{vh} equal "
        "to the first JPEG's decode, quantised")
    log(f"  interact: {len(jpegs)} JPEGs of {vw}x{vh} on {card}; idle {res['idle_fps']} fps, "
        f"flying {res['flying_fps']} fps, device frame {res['device_frame_ms']} ms, encode "
        f"{res['encode_ms_p50']} ms, space {res['key_latency_ms_space_p50']} ms, w "
        f"{res['key_latency_ms_w']} ms, shrink {res['resize_latency_ms_first']} ms, grow past "
        f"the pad {res['resize_latency_ms_grow_pad']} ms")
    return res


def entropy_symbols(zz) -> int:
    """The Huffman symbols a baseline scan codes for (blocks, 64) zig-zag
    coefficients: a block's DC, each nonzero AC, a ZRL for each 16 zeros
    before one, and an EOB unless coefficient 63 is nonzero."""
    blk, col = np.nonzero(zz[:, 1:])
    col = col + 1
    prev = np.where(np.r_[True, blk[1:] != blk[:-1]], 0, np.r_[0, col[:-1]])
    return int(zz.shape[0] + col.size + ((col - prev - 1) >> 4).sum() + (zz[:, 63] == 0).sum())


def fixture_texture(scene_file: str, name: str) -> str:
    """The demo scene at scene_file with its one texture file replaced by
    the committed fixture tests/torch_textures/`name`."""
    scene = pathlib.Path(scene_file)
    old = next(scene.parents[1].joinpath("Textures").iterdir())
    old.unlink()
    old.with_name(name).write_bytes((TEXTURE_FIXTURES / name).read_bytes())
    scene.write_text(scene.read_text().replace(f"Textures/{old.name}", f"Textures/{name}"))
    return scene_file


def textures_phase(torch, pt, dev, card, state) -> None:
    """Textures decoded without PIL (models/texture.decode_texture), with PIL
    blocked in sys.modules for the phase: the committed fixtures against
    PIL's hashes, the textured fixture with a JPEG, a TGA, a lossy WebP,
    an arithmetic-coded JPEG, a DXT1 DDS, a PackBits PSD, an
    irreversible JP2 and an RGB IM texture and cubes with a PNG, two
    TIFFs, a lossless WebP, a BC7 DDS, an RLE SGI, a lossless tiled J2K
    and a Group 4 TIFF one rendered
    on the card and held to the CPU and the oracle, and the decode time of
    a corpus-sized JPEG; see the module docstring."""
    import hashlib

    from relativitypathtracer_tpu_torch.models.texture import decode_texture
    from relativitypathtracer_tpu_torch.utils import image, image_decode
    from relativitypathtracer_tpu_torch.utils.demo_scene import demo_texture, write_demo_scene

    def pil_modules():
        return {m for m, mod in sys.modules.items()
                if mod is not None and (m == "PIL" or m.startswith("PIL."))}

    before, had = pil_modules(), "PIL" in sys.modules
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None  # an import of PIL now raises ImportError
    try:
        record = json.loads((TEXTURE_FIXTURES / "pil_rgb.json").read_text())
        times = []
        for name, want in record["files"].items():
            data = (TEXTURE_FIXTURES / name).read_bytes()
            t0 = time.perf_counter()
            rgb = decode_texture(data)
            times.append(f"{name} {(time.perf_counter() - t0) * 1e3:.2f}")
            check(list(rgb.shape) == want["shape"]
                  and hashlib.sha256(rgb.tobytes()).hexdigest() == want["sha256"],
                  f"textures: {name} decodes to other bytes than PIL's")
        log(f"  {len(times)} committed files equal to PIL's decodes (Pillow {record['pillow']}, "
            f"libjpeg-turbo {record['libjpeg_turbo']}, libwebp {record['libwebp']}), PIL "
            "blocked; decode ms: " + ", ".join(times))
        log("  WebP decode ms: " + ", ".join(t for t in times if ".webp " in t))
        log("  arithmetic-coded JPEG decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith(".jpg") and "arith" in t))
        log("  JPEG-in-TIFF decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith(".tif") and "jpeg" in t))
        log("  DDS/FTEX/BLP decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith((".dds", ".ftc", ".ftu", ".blp"))))
        log("  PSD/SGI/PCX/DCX/Sun/QOI/MSP/ICO/CUR/ICNS/XBM/XPM decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith(LEGACY_SUFFIXES)))
        log("  JPEG 2000 and FITS decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith((".j2k", ".jp2", ".fits"))
            or t.split()[0] in ("ic08.icns", "ic09.icns")))
        log("  FLI/FLC/IM/IMT/GBR/McIdas/PIXAR/SPIDER/XVThumb/IPTC/PCD decode ms: " + ", ".join(
            t for t in times if t.split()[0].endswith(PLUGIN_SUFFIXES)))
        log("  PNM extensions and TIFF rare kinds decode ms: " + ", ".join(
            t for t in times if t.split()[0] in RARE_FIXTURES))
        for kind, fmt, size in TEXTURE_SCENES:
            names = PATHS[kind][1]
            with tempfile.TemporaryDirectory() as tmp:
                if fmt in ("jpg", "png"):
                    scene_file = write_demo_scene(tmp, LEVEL, kind, texture_format=fmt)
                else:
                    scene_file = fixture_texture(write_demo_scene(tmp, LEVEL, kind), fmt)
                tex = next(pathlib.Path(tmp, "Textures").iterdir())
                tex_bytes = tex.read_bytes()
                t0 = time.perf_counter()
                decode_texture(tex_bytes)
                tex_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                host = pt.load_scene_file(scene_file)
                load_s = time.perf_counter() - t0
            scene, meta = pt.build_scene(host, device=dev)
            render = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, with_aux=True, device=dev)
            render(scene, state)  # warm-up and capture
            (img, aux), launches = counted_frame(torch, render, scene, state)
            check(set(launches) == set(names) and all(launches.values()),
                  f"textures: {kind} with a {fmt} texture launched {launches}, not {names}")
            check(bool(torch.isfinite(img).all()) and int(aux["hits"]) > 0,
                  f"textures: {kind} frame {counts(aux)}")
            log(f"  {kind} with its {tex.name} ({len(tex_bytes)} bytes, decode "
                f"{tex_ms:.2f} ms; load_scene_file {load_s:.2f} s): atlas "
                f"{tuple(scene.tex_quads.shape)}, one graphed frame's launches {launches}")
            small, small_aux = img, aux
            if size != (WIDTH, HEIGHT):
                small, small_aux = pt.build_render_fn(meta, size[0], size[1], -1, with_aux=True,
                                                      device=dev)(scene, state)
            parity(torch, pt, host, state, small, small_aux, size)
            oracle_check(torch, f"{kind} ({fmt} texture)", scene, meta, state, img, card)
        big = demo_texture(BIG_TEXTURE)
        data = image.encode_jpeg(big)
        coef, orig = {}, image_decode._decode_sequential

        def keep(*args):
            orig(*args)
            coef["zz"] = np.frombuffer(args[5], np.int32).reshape(-1, 64)

        image_decode._decode_sequential = keep
        try:
            t0 = time.perf_counter()
            rgb = image_decode.decode_jpeg(data)
            big_s = time.perf_counter() - t0
        finally:
            image_decode._decode_sequential = orig
        # JPEG keeps each block's mean: 16x16 means (a 4:2:0 MCU) within 4
        # levels (1.750 in the runs so far: the loss is the q85 encode's)
        n = BIG_TEXTURE // 16
        means = [a.astype(np.float64).reshape(n, 16, n, 16, 3).mean((1, 3)) for a in (rgb, big)]
        err = float(np.abs(means[0] - means[1]).max())
        check(rgb.shape == big.shape and err < 4.0,
              f"textures: the {BIG_TEXTURE}x{BIG_TEXTURE} decode {rgb.shape}, block means {err} "
              "levels off the image's")
        log(f"  a {BIG_TEXTURE}x{BIG_TEXTURE} seeded texture (utils/demo_scene.demo_texture) "
            f"through encode_jpeg: {len(data):,} bytes, {entropy_symbols(coef['zz']):,} entropy "
            f"symbols in {coef['zz'].shape[0]:,} blocks, decode_jpeg {big_s:.3f} s on the card "
            f"host's CPU (16x16 block means within {err:.3f} levels of the image's)")
    finally:
        if had:
            sys.modules["PIL"] = saved
        else:
            del sys.modules["PIL"]
    added = pil_modules() - before
    check(not added, f"textures: PIL modules imported: {sorted(added)}")
    log(f"  no PIL module imported (PIL {'was' if before else 'was not'} loaded before the phase)")


def octree_phase(torch, pt, host, dev, card):
    """The octree walk of a 16,384-ray fan from the camera over the textured
    fixture's mesh on the card: converged; against the K5 route, the same
    hit/miss on at least 99.9% of rays and t within a relative 1e-4 where
    both hit; against the same walk on the CPU, the same hit/miss and t
    within a relative 1e-6."""
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.ops.mesh_intersect import mesh_intersect_shared
    from relativitypathtracer_tpu_torch.ops.octree_traverse import octree_intersect
    from relativitypathtracer_tpu_torch.render import mesh_perm_tensors

    rng = np.random.default_rng(11)
    d = rng.uniform(-0.35, 0.35, (3, 16384)).astype(np.float32)
    d[0] += 1.0 / 3.2  # around the mesh's rest-frame centre (1, -0.2, 3.2)
    d[1] += -0.2 / 3.2
    d[2] = 1.0
    runs = []
    for where in (torch.device(dev), torch.device("cpu")):
        scene, meta = pt.build_scene(host, device=where)
        i, root = meta.mesh_ids[0], meta.mesh_roots[0]
        args = (scene.objects.m[i], scene.objects.inv_m[i], torch.zeros(3, device=where),
                torch.as_tensor(d).to(where))
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = octree_intersect(scene.mesh, root, *args, stats=stats)
        torch.cuda.synchronize()
        runs.append((out, stats["iterations"], (time.perf_counter() - t0) * 1e3))
        if len(runs) == 1:  # on the card
            _build.LAUNCHES.clear()
            k5 = mesh_intersect_shared(scene.mesh, *args, mesh_perm_tensors(meta, where)[0],
                                       scene.mesh_static[0])
            torch.cuda.synchronize()
            check(_build.LAUNCHES.get("rpt_shared_walk", 0) == 1, "octree: no K5 launch")
    ((t, _, _, valid, conv), its, ms), ((ct, _, _, cvalid, cconv), cits, cms) = runs
    check(conv and cconv, "octree: the walk did not converge")
    kt, kvalid = k5[0], k5[3]
    agree = float((valid == kvalid).float().mean())
    both = valid & kvalid
    rel = float(((t[both] - kt[both]).abs() / kt[both]).max())
    check(agree >= 0.999 and int(both.sum()) > 1000 and rel <= 1e-4,
          f"octree vs K5: hit/miss agree on {agree:.4%}, t rel {rel:.2e}")
    check(torch.equal(valid.cpu(), cvalid), "octree: card and CPU walks differ in hit/miss")
    crel = float(((t.cpu()[cvalid] - ct[cvalid]).abs() / ct[cvalid]).max())
    check(crel <= 1e-6, f"octree: card and CPU t differ by {crel:.2e}")
    log(f"  octree on {card}: 16,384 rays, {int(valid.sum())} hits, converged in {its} "
        f"iterations ({ms:.1f} ms on the card; CPU {cits} iterations, {cms:.1f} ms); against "
        f"K5 hit/miss agree on {agree:.4%}, t within {rel:.2e} relative; against the CPU walk "
        f"t within {crel:.2e} (bitwise equal: {bool(torch.equal(t.cpu(), ct))})")


def other_scene(scene):
    """The scene with other velocities and colours: the same shapes."""
    return scene._replace(objects=scene.objects._replace(
        velocity=scene.objects.velocity.flip(0) * 0.8,
        color=scene.objects.color.roll(1, dims=1)))


def graph_phase(torch, pt, path, scene, meta, states, render, frames, launches, capture_s,
                graph_mib, card):
    """The graphed frame (build_render_fn: one CUDA graph, utils/frame_graph)
    against the eager frame (render_constants, then trace_frame under
    full_precision): each of the three graphed frames, kept while the later
    ones replayed, equal to the eager frame of its state to the bit with
    equal counts, and an eager frame's launches equal to a replay's; a second
    scene of the same shapes through the same graph, with no new capture,
    equal to its own eager frame; then p50/p95 of both in turns (eager,
    graph, graph, eager; 20 frames each), the capture seconds, the bytes a
    replay copies into the graph's inputs and that copy's device ms (the
    renderer's latest graph, median of 20), and the peak memory above what
    was held before, of the capture and three frames and of eager frames."""
    from torch.utils import _pytree as pytree

    from relativitypathtracer_tpu_torch import render as prender

    consts = prender.render_constants(meta, WIDTH, HEIGHT, 1, torch.device(DEVICE))

    def eager(sc, st):
        with prender.full_precision():
            return prender.trace_frame(sc, meta, st, *consts, -1, WIDTH, HEIGHT, True)

    per_frame = {k: n // len(states) for k, n in launches.items()}
    check(all(n % len(states) == 0 for n in launches.values()), f"{path}: launches {launches}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i, ((img, aux), st) in enumerate(zip(frames, states)):
        (want, waux), eager_launches = counted_frame(torch, eager, scene, st)
        check(torch.equal(img, want) and aux == counts(waux),
              f"{path}: graphed frame {i} differs from the eager frame")
        check(eager_launches == per_frame,
              f"{path}: eager launches {eager_launches}, a replay's {per_frame}")
    eager_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    check(not torch.equal(frames[0][0], frames[2][0]), f"{path}: the states give one frame")
    other = other_scene(scene)
    (got, gaux), (want, waux) = render(other, states[2]), eager(other, states[2])
    check(torch.equal(got, want) and counts(gaux) == counts(waux)
          and not torch.equal(got, frames[2][0]) and render.captures == 1,
          f"{path}: the second scene's graphed frame differs from its eager frame")
    statics = next(reversed(render.graphs.values())).statics
    inputs = [x for x in pytree.tree_flatten((scene, states[2]))[0] if torch.is_tensor(x)]
    copy_ms = time_ms(torch, lambda: torch._foreach_copy_(statics, inputs))
    turns = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        turns[name].append(p50_p95(torch, eager if name == "eager" else render, scene,
                                   states[2]))
    log(f"  graph on {path}: the three graphed frames (kept) and a second scene's equal to the "
        f"eager frames to the bit, launches a replay as an eager frame's; capture "
        f"{capture_s:.3f} s (warm-up, capture, replay), {render.input_bytes:,} input bytes "
        f"copied a call ({copy_ms:.3f} ms), peak memory {graph_mib:.0f} MiB (capture and 3 frames) against "
        f"{eager_mib:.0f} MiB (eager frames); in turns on {card}, p50/p95 ms: eager "
        + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in turns["eager"]) + "; graph "
        + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in turns["graph"]))


def trace_key(name: str):
    """The launch-count key (before any "/route") of the port kernel whose
    name, in a graph or a profiler trace, is `name`, or None."""
    for key, parts in TRACE_NAMES.items():
        if all(p in name for p in parts) and ("batched" in name) == ("batched" in key):
            return key
    return None


def port_kernel(name: str) -> bool:
    """Whether a mangled kernel name is one of csrc/*.cu's: they live in
    anonymous namespaces, which the mangled name tags with the source's
    name."""
    return any(f"_{p.stem}_cu_" in name for p in CSRC.glob("*.cu"))


def replay_verdict(names, added, per_frame, what) -> dict:
    """The traced-replay check on `names`, the kernels a replayed graph
    holds (utils/frame_graph.kernel_names): the port's among them, by launch
    key, must be those the replay added to the launch counts (`added`), each
    as many times, and those `per_frame` (an eager frame's or the path's
    replays' counts a frame). Raises CheckFailed; returns the counts by key."""
    added = {k.split("/")[0]: n for k, n in added.items()}
    check(added == {k.split("/")[0]: n for k, n in per_frame.items()},
          f"{what}: the replay counted {added}, a frame {per_frame}")
    held = collections.Counter(trace_key(n) for n in names)
    held.pop(None, None)
    unmapped = sorted({n[:80] for n in names if port_kernel(n) and trace_key(n) is None})
    check(dict(held) == added and not unmapped,
          f"{what}: the replayed graph holds {dict(held)}, the counts say {added} ({len(names)} "
          f"kernel nodes; the port's unmapped: {unmapped})")
    return added


def replay_check(torch, render, scene, state, per_frame, what):
    """One counted call of a graphed renderer, held by replay_verdict to the
    kernel nodes of the graph it replayed, which are exactly what a replay
    launches. Then one more call under torch.profiler, printed beside it:
    the port's kernels its trace holds against the graph's (no verdict: a
    trace has been seen to lack a kernel that the replay ran); returns the
    counts by key that trace lacked."""
    from torch.profiler import ProfilerActivity, profile

    from relativitypathtracer_tpu_torch.utils.frame_graph import kernel_names

    _, added = counted_frame(torch, render, scene, state)
    names = kernel_names(next(reversed(render.graphs.values())).graph)
    counted = replay_verdict(names, added, per_frame, what)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, state)
        torch.cuda.synchronize()
    events = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = collections.Counter(trace_key(n) for n in events)
    traced.pop(None, None)
    lacking = {k: n - traced.get(k, 0) for k, n in counted.items() if traced.get(k, 0) < n}
    log(f"  {what}: the replayed graph holds each of the path's kernels as often as the "
        f"replay counted them ({sum(counted.values())} of its {len(names)} kernel nodes); a "
        f"profiler trace of one more replay: {sum(traced.values())} of them in "
        f"{len(events)} device events" + (f", lacking {lacking}" if lacking else ""))
    return lacking


def counted_frame(torch, render, scene, state):
    """One frame of render with every launch count set to 0 just before and
    read just after: (output, launches)."""
    from relativitypathtracer_tpu_torch.ops.kernels import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = render(scene, state)
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def p50_p95(torch, render, scene, state, frames: int = 20) -> tuple[float, float]:
    from relativitypathtracer_tpu_torch.utils.timing import cuda_frame_times_ms, percentile

    times = cuda_frame_times_ms(render, scene, state, frames=frames, warmup=3)
    return percentile(times, 50), percentile(times, 95)


def counts(aux) -> dict:
    return {k: int(v) for k, v in aux.items()}


def sharded_phase(torch, pt, scenes, hosts, states, card):
    """The sharded renderer (parallel/tiles.py) on the card; see the module
    docstring."""
    from relativitypathtracer_tpu_torch.parallel import tiles
    from relativitypathtracer_tpu_torch.utils import aot

    dev = torch.device(DEVICE)
    st = states[2]
    logical = [dev] * SHARDS
    for path in ("textured", "instances"):
        scene, meta = scenes[path]
        single = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, with_aux=True, device=dev)
        (want, waux), one = counted_frame(torch, single, scene, st)
        renders = {}
        for assign in ("strided", "contiguous"):
            render = renders[assign] = tiles.build_sharded_render_fn(
                meta, WIDTH, HEIGHT, -1, logical, with_aux=True, band_assign=assign)
            render(scene, st)  # the capture: one graph of the card's four shards
            (img, aux), launches = counted_frame(torch, render, scene, st)
            check(len(render.parts) == 1 and render.parts[0].captures == 1,
                  f"sharded {path} {assign}: graphs {[p.captures for p in render.parts]}")
            check(tuple(img.shape) == (HEIGHT, WIDTH, 3) and torch.equal(img, want),
                  f"sharded {path} {assign}: frame differs from build_render_fn's")
            check(counts(aux) == counts(waux), f"sharded {path} {assign}: counts {counts(aux)}"
                  f" against {counts(waux)}")
            check(launches == {k: SHARDS * n for k, n in one.items()},
                  f"sharded {path} {assign}: launches {launches}, a single frame's {one}")
            log(f"  sharded {path} {WIDTH}x{HEIGHT} on {SHARDS} logical shards ({assign}): "
                f"equal to build_render_fn's frame and counts {counts(aux)}; launches a frame "
                f"{launches} ({SHARDS}x a single frame's)")
        (sp50, sp95), (p50, p95) = (p50_p95(torch, renders["strided"], scene, st),
                                    p50_p95(torch, single, scene, st))
        log(f"  sharded {path} frame on {card}: p50 {sp50:.3f} ms, p95 {sp95:.3f} ms on "
            f"{SHARDS} logical shards (strided); single frame p50 {p50:.3f} ms, p95 "
            f"{p95:.3f} ms (20 frames each)")

    # folded msaa 2 against the CPU's sharded frame and the card's loop frame
    scene, meta = scenes["textured"]
    render = tiles.build_sharded_render_fn(meta, 512, 384, -1, logical, msaa=2, with_aux=True)
    (img, aux), launches = counted_frame(torch, render, scene, st)
    loop, laux = pt.build_render_fn(meta, 512, 384, -1, 2, with_aux=True, device=dev)(scene, st)
    cpu_scene, cpu_meta = pt.build_scene(hosts["textured"], device="cpu")
    cpu_img, cpu_aux = tiles.build_sharded_render_fn(cpu_meta, 512, 384, -1, ["cpu"] * SHARDS,
                                                     msaa=2, with_aux=True)(
        cpu_scene, pt.FrameState(st.cam_velocity.cpu(), st.cam_pos.cpu()))
    for name, ref, raux in (("the CPU's sharded frame", cpu_img, cpu_aux),
                            ("the card's per-sample loop", loop, laux)):
        diff = (img.cpu() - ref.cpu()).abs()
        frac_bad = float((diff.amax(dim=-1) > 1e-3).float().mean())
        log(f"  sharded textured 512x384 msaa 2 (folded, {SHARDS} shards) against {name}: "
            f"frac_bad {frac_bad:.6f}, mean diff {float(diff.mean()):.3e}, counts "
            f"{counts(aux)} against {counts(raux)}")
        check(frac_bad <= 0.002 and float(diff.mean()) < 1e-4,
              f"folded sharded frame off {name}")
        check(counts(aux)["hits"] == counts(raux)["hits"], f"folded hits against {name}")
    check(set(launches) == set(PATHS["textured"][1]), f"folded launches {launches}")

    # the deal's load: mesh-hit rays per shard, strided against contiguous
    per_block, rows, cols = tiles.per_block_mesh_work(scene, meta, WIDTH, HEIGHT, SHARDS,
                                                      state=st)
    for assign in ("strided", "contiguous"):
        work, skew = tiles.partition_work(per_block, rows, cols, SHARDS, assign)
        log(f"  textured mesh work per shard ({assign}, {rows}x{cols} blocks): {work.tolist()}, "
            f"skew (max / mean) {skew:.3f}")

    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        cards = tiles.default_devices(min(n_cards, SHARDS))
        for path in ("textured", "instances"):
            scene, meta = scenes[path]
            want, waux = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, with_aux=True,
                                            device=dev)(scene, st)
            img, aux = tiles.build_sharded_render_fn(meta, WIDTH, HEIGHT, -1, cards,
                                                     with_aux=True)(scene, st)
            check(torch.equal(img, want) and counts(aux) == counts(waux),
                  f"sharded {path} on {len(cards)} cards differs from build_render_fn's")
            loaded = aot.load_render(aot.export_sharded_render(scene, meta, WIDTH, HEIGHT, cards))
            check(len(loaded.parts) == len(cards) and torch.equal(loaded(scene, st), want),
                  f"exported sharded {path} on {len(cards)} cards differs from build_render_fn's")
            log(f"  sharded {path} on {len(cards)} distinct cards, live and exported: equal to "
                f"build_render_fn's")
    else:
        log("  sharded on distinct cards: not run (this host has one CUDA device)")
    out = tiles.dryrun_multichip(SHARDS)
    log(f"  dryrun_multichip({SHARDS}) on the card: {out}")


@contextlib.contextmanager
def no_full_unpickle(torch, what: str):
    """Fails `what` if, while the block runs, torch.load is called with
    weights_only=False (a full unpickle, which can run code from the
    artifact) or torch's export loader logs its fallback to one."""
    import logging

    real, unsafe, fallbacks = torch.load, [], []

    def load(*args, **kwargs):
        if kwargs.get("weights_only") is False:
            unsafe.append(args)
        return real(*args, **kwargs)

    class Fallbacks(logging.Handler):
        def emit(self, record):
            if "weights_only" in str(record.msg):
                fallbacks.append(record.msg)

    handler, logger = Fallbacks(), logging.getLogger("torch._export.serde.serialize")
    torch.load = load
    logger.addHandler(handler)
    try:
        yield
    finally:
        torch.load = real
        logger.removeHandler(handler)
    check(not unsafe and not fallbacks, f"{what}: torch.load(weights_only=False) ran "
          f"{len(unsafe)} times, torch logged {len(fallbacks)} fallbacks to it")


def export_phase(torch, pt, scenes, states, card, live_launches, live_frames):
    """The exported renderer (utils/aot.py) on the card; see the module
    docstring. live_launches over live_frames frames are the live path's."""
    from relativitypathtracer_tpu_torch.parallel import tiles
    from relativitypathtracer_tpu_torch.utils import aot

    dev = torch.device(DEVICE)
    for path in ("textured", "instances"):
        scene, meta = scenes[path]
        t0 = time.perf_counter()
        data = aot.export_render(scene, meta, WIDTH, HEIGHT, device=dev)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        with no_full_unpickle(torch, f"export {path}: load_render"):
            render = aot.load_render(data)
        t_load = time.perf_counter() - t0
        live = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, device=dev)
        t0 = time.perf_counter()
        render(scene, states[0])
        torch.cuda.synchronize()
        t_capture = time.perf_counter() - t0
        for i, (sc, st) in enumerate([(scene, s) for s in states]
                                     + [(other_scene(scene), states[2])]):
            got, launches = counted_frame(torch, render, sc, st)
            want = live(sc, st)
            check(torch.equal(got, want), f"export {path}: loaded frame {i} differs from the "
                  f"live frame")
            per_frame = {k: n // live_frames for k, n in live_launches[path].items()}
            check(launches == per_frame, f"export {path}: launches {launches}, live {per_frame}")
        check(render.captures == 1, f"export {path}: {render.captures} captures")
        replay_check(torch, render, scene, states[2], per_frame, f"export {path}")
        p50, p95 = p50_p95(torch, render, scene, states[2])
        log(f"  export {path} {WIDTH}x{HEIGHT}: exported in {t_export:.1f} s, {len(data)} "
            f"bytes, loaded in {t_load:.1f} s, captured in {t_capture:.3f} s; the loaded frames "
            f"(replays of one graph) at the three states and a second scene equal to the live "
            f"frames, launches a frame as the live frame's; loaded frame on {card}: p50 "
            f"{p50:.3f} ms, p95 {p95:.3f} ms (20 frames)")

    scene, meta = scenes["textured"]
    devices = [dev] * 2
    t0 = time.perf_counter()
    data = aot.export_sharded_render(scene, meta, 512, 384, devices)
    with no_full_unpickle(torch, "export_sharded_render: load_render"):
        loaded = aot.load_render(data)
    got = loaded(scene, states[2])
    want = tiles.build_sharded_render_fn(meta, 512, 384, -1, devices)(scene, states[2])
    check(torch.equal(got, want), "export_sharded_render: loaded frame differs")
    log(f"  export_sharded_render textured 512x384 on 2 logical shards: equal to the live "
        f"sharded frame, {len(data)} bytes, {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "tools/export_renderer_torch.py", "--fixture",
                           "textured", "--device", "cuda", "--selfcheck"],
                          cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=300)
    log("  " + "\n  ".join(proc.stdout.strip().splitlines())
        + f"\n  export tool: exit {proc.returncode}, {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, f"export tool --selfcheck failed:\n{proc.stderr[-2000:]}")
    check("Logging error" not in proc.stderr and "weights_only" not in proc.stderr,
          f"export tool: torch's loader fell back to a full unpickle:\n{proc.stderr[-2000:]}")
    log("  load_render of each artifact (single, sharded, the tool's): no "
        "torch.load(weights_only=False), no fallback logged")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import relativitypathtracer_tpu_torch as pt
    from relativitypathtracer_tpu_torch import render as prender
    from relativitypathtracer_tpu_torch.ops.kernels import _build
    from relativitypathtracer_tpu_torch.ops.kernels import analytic_kernels as ak
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_batch as mb
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_kernels as mk
    from relativitypathtracer_tpu_torch.ops.kernels import mesh_large as ml
    from relativitypathtracer_tpu_torch.ops.kernels import shadow_chain as sc
    from relativitypathtracer_tpu_torch.ops.kernels import texture_kernel as tk
    from relativitypathtracer_tpu_torch.utils import largedemo
    from relativitypathtracer_tpu_torch.utils.demo_scene import LARGE_LEVEL, write_demo_scene

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    dev = torch.device(DEVICE)
    states = [
        pt.FrameState(torch.zeros(3, device=dev), torch.tensor([0.0, 0, 0, 0], device=dev)),
        pt.FrameState(torch.zeros(3, device=dev), torch.tensor([1 / 30, 0, 0, 0], device=dev)),
        pt.FrameState(torch.tensor([0.5, 0.0, 0.0], device=dev),
                      torch.tensor([2 / 30, 0, 0, 0], device=dev)),
    ]
    # The wrappers the main path calls, by the module attribute it calls
    # them through; hooks record each one's first-frame inputs.
    hooks = {"rpt_shadow_chain": (prender, "shadow_chain"),
             "rpt_analytic_nearest": (prender, "analytic_nearest_shared"),
             "rpt_cone_table": (mk, "cone_table"),
             "rpt_live_cull": (mk, "live_cull"),
             "rpt_bucket_order": (mk, "bucket_order"),
             "rpt_shared_walk": (mk, "shared_walk"),
             "rpt_general_walk": (mk, "general_walk"),
             "rpt_analytic_min_t": (prender, "analytic_min_t_general"),
             "rpt_footprint_sample": (prender, "footprint_fetch"),
             "rpt_batched_shared_walk": (mb, "batched_shared_walk"),
             "rpt_batched_general_walk": (mb, "batched_general_walk"),
             "rpt_large_shared_walk": (ml, "large_shared_walk"),
             "rpt_large_general_walk": (ml, "large_general_walk")}
    originals = {name: getattr(mod, attr) for name, (mod, attr) in hooks.items()}
    # K4's list functions as the walks call them, with their twins
    list_hooks = [(mk, "live_chunk_lists", mk.live_chunk_lists_plain),
                  (mb, "live_chunk_lists_multi", mb.live_chunk_lists_multi_plain),
                  (ml, "large_live_lists", ml.large_live_lists_plain)]
    list_fns = {attr: getattr(mod, attr) for mod, attr, _ in list_hooks}
    list_plains = {attr: plain for _, attr, plain in list_hooks}
    results, launches_by_path, hosts, scenes = {}, {}, {}, {}
    # the xl scene, its pickle and the module entry's scenes, until the path ends
    xl_dir = tempfile.TemporaryDirectory(prefix="rpt_xl_")

    for path, (kind, names, cpu_size) in PATHS.items():
        log(f"--- path {path} ---")
        t_path = t0 = time.perf_counter()
        if kind == "xl":
            src, what = xl_source(largedemo, xl_dir.name)
            scene, meta = largedemo.load_large_scene(xl_dir.name, XL_LEVELS, dev, src)
            build_s, t1 = time.perf_counter() - t0, time.perf_counter()
            host = largedemo.load_large_host(xl_dir.name, XL_LEVELS, src)
            log(f"  xl: {what} ({src}) subdivided {XL_LEVELS} times; load_large_scene "
                f"{build_s:.1f} s (subdivision, parse, normals, octree, pickle, build_scene), the "
                f"host scene again from its pickle {time.perf_counter() - t1:.1f} s")
        else:
            with tempfile.TemporaryDirectory() as tmp:
                host = pt.load_scene_file(write_demo_scene(tmp, LEVEL, kind))
                scene, meta = pt.build_scene(host, device=dev)
        hosts[path] = host
        scenes[path] = (scene, meta)
        log(f"  scene: {meta.num_tris} triangles, spheres {meta.sphere_ids}, cubes "
            f"{meta.cube_ids}, textured {meta.textured_ids}, atlas "
            f"{tuple(scene.tex_quads.shape)}, lights {meta.light_ids}, built in "
            f"{time.perf_counter() - t0:.1f} s")
        tris = {"blob": 20 * 4 ** LEVEL, "textured": 20 * 4 ** LEVEL,
                "instances": 20 * 4 ** LEVEL, "large": 20 * 4 ** LARGE_LEVEL, "xl": XL_SHAPE[0]}
        check(meta.light_ids and meta.num_tris == tris.get(kind, meta.num_tris), "fixture shape")
        if kind == "instances":  # four instances of one mesh in one pool of 640 chunks
            check(len(meta.mesh_ids) == 4 and sum(meta.mesh_chunk_counts) == 640
                  and scene.mesh_batch is not None, "instances: the fused pool")
        if kind == "large":  # the large tier: 10,240 chunks, no pool
            check(scene.mesh_static[0].gen_rec is not None
                  and scene.mesh_static[0].spheres.shape[0] == 10240, "large: the large tier")
        if kind == "xl":  # the XL tier: 39,744 chunks in 311 supers of 128
            C = scene.mesh_static[0].spheres.shape[0]
            S = ml._super_s(C)
            n_super = -(-C // S)
            shape = (meta.num_tris, C, n_super, C - (n_super - 1) * S, n_super * S // 32)
            check(scene.mesh_static[0].gen_rec is not None and S == ml.S_SUPER_XL
                  and shape == XL_SHAPE, f"xl: (triangles, chunks, supers, chunks of the last "
                  f"super, bit words) {shape}, supers of {S}")
        render = pt.build_render_fn(meta, WIDTH, HEIGHT, -1, with_aux=True, device=dev)

        # The hooks record each wrapper's inputs in the first call's eager
        # warm-up, not in its capture (whose tensors live in the graph's pool).
        captured, list_calls, recording = {}, [], [True]
        for name, (mod, attr) in hooks.items():
            def rec(*args, _fn=originals[name], _name=name):
                if _name == "rpt_footprint_sample":
                    _name += "/" + tk.texture_route(args[0].shape[0])
                if (recording[0] and _name not in captured
                        and not torch.cuda.is_current_stream_capturing()):
                    captured[_name] = args
                return _fn(*args)

            setattr(mod, attr, rec)
        for mod, attr, _ in list_hooks:
            def rec_list(*args, _fn=list_fns[attr], _name=attr, **kwargs):
                if recording[0] and not torch.cuda.is_current_stream_capturing():
                    list_calls.append((_name, _fn, args, kwargs))
                return _fn(*args, **kwargs)

            setattr(mod, attr, rec_list)
        # which two-level list function large_live_lists takes
        route = collections.Counter()
        route_fns = {attr: getattr(ml, attr) for attr in set(LIST_ROUTE.values())}
        for attr, fn in route_fns.items():
            setattr(ml, attr, lambda *a, _fn=fn, _n=attr, **k: route.update([_n]) or _fn(*a, **k))

        # --- the capture: the first call warms up, captures and replays ------
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        render(scene, states[0])
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        recording[0] = False
        for name, (mod, attr) in hooks.items():
            setattr(mod, attr, originals[name])
        for mod, attr, _ in list_hooks:
            setattr(mod, attr, list_fns[attr])
        for attr, fn in route_fns.items():
            setattr(ml, attr, fn)
        check(render.captures == 1, f"{path}: {render.captures} captures")
        if path in LIST_ROUTE:
            check(set(route) == {LIST_ROUTE[path]},
                  f"{path}: large_live_lists took {dict(route)}, not {LIST_ROUTE[path]}")

        # --- the path: three graphed frames, counts from 0 -------------------
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        frames = []
        for st in states:
            img, aux = render(scene, st)
            frames.append((img, {k: int(v) for k, v in aux.items()}))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        graph_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
        launches_by_path[path] = launches
        log(f"  launches: {launches} (three replays)")
        for img, aux in frames:
            check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(img.shape)}")
            check(bool(torch.isfinite(img).all()), "non-finite pixels")
            check(aux["hits"] > 0 and aux["shadow_rays"] > 0, f"counts {aux}")
            lit, cast = aux["lit_rays"], aux["shadow_rays"]
            check(0 < lit < cast or path in UNSHADOWED and 0 < lit <= cast,
                  f"no lit or no occluded lanes: {aux}")
            log(f"  frame: {aux}, mean {float(img.mean()):.6f}")
        for name in names:
            check(launches.get(name, 0) > 0, f"{path}: {name} was not launched")
            check(name in captured, f"{path}: {name}: no inputs captured")
        for name in launches:
            check(name in names, f"{path}: unexpected launches of {name}")
        if kind == "xl":
            widths = [captured[n][3].shape[1] for n in ("rpt_large_shared_walk",
                                                        "rpt_large_general_walk")]
            check(widths == [XL_SHAPE[4]] * 2, f"xl: bit rows {widths} words")
            log(f"  xl route: supers of {S}, {n_super} of them (the last {shape[3]} chunks), "
                f"large_live_lists took {dict(route)} in the warm-up and capture, bit rows of "
                f"K11 and K12 {widths[0]:,} words")
        graph_phase(torch, pt, path, scene, meta, states, render, frames, launches, capture_s,
                    graph_mib, card)
        replay_check(torch, render, scene, states[2],
                     {k: n // len(states) for k, n in launches.items()}, f"graph on {path}")

        originals_by_key = {n: originals[n.split("/")[0]] for n in names}
        results[path] = compare_kernels(torch, (ak, mk, sc, tk, mb, ml), meta, captured,
                                        originals_by_key, names, path)
        if "rpt_live_cull" in names:
            compare_lists(torch, mk, path, list_calls, list_plains)
        else:
            check(not list_calls, f"{path}: list builds on a path without meshes")
        del captured, list_calls

        img, aux = frames[2]
        if cpu_size != (WIDTH, HEIGHT):
            small = pt.build_render_fn(meta, cpu_size[0], cpu_size[1], -1, with_aux=True,
                                       device=dev)
            img, aux = small(scene, states[2])
        parity(torch, pt, host, states[2], img, aux, cpu_size)
        frame_time(torch, render, scene, states[2], card)
        oracle_check(torch, path, scene, meta, states[2], frames[2][0], card)
        if kind == "xl":
            largedemo_phase(largedemo, xl_dir.name, src, card)
            xl_dir.cleanup()
        log(f"  path {path}: {time.perf_counter() - t_path:.1f} s")

    log("--- path textured, msaa 2, 512x384 ---")
    scene, meta = pt.build_scene(hosts["textured"], device=dev)
    img, aux = pt.build_render_fn(meta, 512, 384, -1, 2, with_aux=True, device=dev)(
        scene, states[2])
    check(bool(torch.isfinite(img).all()) and int(aux["hits"]) > 0, f"msaa 2 frame {aux}")
    parity(torch, pt, hosts["textured"], states[2], img, aux, (512, 384), msaa=2)

    log("--- textures: every format decoded without PIL ---")
    t0 = time.perf_counter()
    textures_phase(torch, pt, dev, card, states[2])
    log(f"  textures phase: {time.perf_counter() - t0:.1f} s")
    log(f"--- viewer: textured, {VIEWER_SIZE[0]}x{VIEWER_SIZE[1]} ---")
    t0 = time.perf_counter()
    viewer_phase(torch, pt, hosts["textured"], dev, card, launches_by_path["textured"],
                 len(states))
    log(f"  viewer phase: {time.perf_counter() - t0:.1f} s")
    log(f"--- interact: textured, {VIEWER_SIZE[0]}x{VIEWER_SIZE[1]}, the web viewer over HTTP ---")
    t0 = time.perf_counter()
    interact = interact_phase(card)
    log(f"  interact phase: {time.perf_counter() - t0:.1f} s")
    log("--- octree: textured ---")
    t0 = time.perf_counter()
    octree_phase(torch, pt, hosts["textured"], dev, card)
    log(f"  octree phase: {time.perf_counter() - t0:.1f} s")
    log(f"--- sharded: textured and instances, {SHARDS} shards ---")
    t0 = time.perf_counter()
    sharded_phase(torch, pt, scenes, hosts, states, card)
    log(f"  sharded phase: {time.perf_counter() - t0:.1f} s")
    log("--- export: textured and instances ---")
    t0 = time.perf_counter()
    export_phase(torch, pt, scenes, states, card, launches_by_path, len(states))
    log(f"  export phase: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, (kid, source, replaces) in KERNELS.items():
        path = REPORT_FROM.get(kid, "textured")
        r = results[path][name]
        kernels.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches_by_path[path][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"], "path": path})
    xl_kernels = [{"name": f"{KERNELS[n][0]} {n}", "route": "cuda", "source": KERNELS[n][1],
                   "replaces": KERNELS[n][2], "launches": launches_by_path["xl"][n],
                   **results["xl"][n], "path": "xl"}
                  for n in (*K4, "rpt_large_shared_walk", "rpt_large_general_walk")]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(interact))
    print(json.dumps({"xl_kernels": xl_kernels}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
