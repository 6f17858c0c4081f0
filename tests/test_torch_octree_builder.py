"""The port's C++ octree builder (csrc/octree_builder.cpp, compiled at first
use by ops/kernels/_build.build_host into build/host/) against the JAX
package's numpy builder, bit for bit: the seven arrays of the octree (node
bounds, list starts and counts, children, neighbours, the triangle pool),
its depth, the mesh roots and each root's reachable triangles and seeded
range. tests/test_torch_octree.py holds it to the port's own numpy twin
(models/octree.generate_octree_plain) on the same cases.

The meshes, parsed by each package's OBJ loader: the blob fixture at
subdivision levels 2-5 (80-20,480 triangles), bunny's stand-in (4,968
triangles), the two-mesh pools in both orders (the root is seeded with the
whole pool but bounded by the new mesh), a one-triangle mesh and a mesh of
zero-area triangles. Blob level 4 is the FMA case: with a*b + c contracted
into one FMA (g++ -march=native on an FMA host, without -ffp-contract=off)
the SAT test keeps triangle 3825 in 5 nodes that numpy drops it from.

The JAX side runs its numpy builder with its `_NATIVE` set to None for the
call, as tests/test_native_octree.py does. Also: no module of the port reads
the JAX-era native/ builder; a missing or failing compiler raises, and the
scene build then raises too (no numpy fallback); two processes building at
once both load the library.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from torch_port_fixtures import (
    OCTREE_CASES,
    assert_same_octree,
    octree_case,
    octree_objs,
    port_mesh,
)

from relativitypathtracer_tpu_torch.models import octree
from relativitypathtracer_tpu_torch.ops.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "relativitypathtracer_tpu_torch"


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    return octree_objs(tmp_path_factory.mktemp("octree_objs"))


_CACHE = {}


def built(objs, case: str, side: str):
    """A case's mesh by side ("cpp", "jax"), built once a module."""
    if (case, side) not in _CACHE:
        _CACHE[case, side] = octree_case(objs, case, side)
    return _CACHE[case, side]


@pytest.mark.parametrize("case", list(OCTREE_CASES))
def test_cpp_builder_equals_the_jax_numpy_builder(objs, case):
    got, want = built(objs, case, "cpp"), built(objs, case, "jax")
    assert_same_octree(got, want)
    assert len(got.octree) > 1


def test_blob_level4_drops_the_grazing_triangle(objs):
    """The FMA case pinned: triangle 3825 of blob level 4 grazes five boxes;
    rounded product by product, the SAT test drops it from all five, and the
    pool holds 84,437 entries (an FMA build keeps it: 84,442)."""
    oct = built(objs, "blob4_fma", "cpp").octree
    assert (len(oct), len(oct.oct_tris)) == (19625, 84437)
    for node in (6, 12695, 14119, 14437, 14453):
        start, count = oct.node_tris_index[node], oct.node_tris_count[node]
        assert 3825 not in oct.oct_tris[start:start + count], node
    assert oct.node_children[14453][0] == -1  # a leaf


def test_builder_built_for_this_host_still_equals_numpy(objs, tmp_path, monkeypatch):
    """With -march=native added (FMA instructions where the host has them),
    -ffp-contract=off still keeps every product rounded: blob level 4 equal
    to the JAX package's numpy builder. Another flag set is another
    library: its hash names it."""
    monkeypatch.setattr(_build, "HOST_DIR", tmp_path / "host")
    plain_path = _build.build_host()
    native_path = _build.build_host(_build.HOST_FLAGS + ("-march=native",))
    assert native_path != plain_path and native_path.parent == tmp_path / "host"
    monkeypatch.setattr(octree, "_LIB", octree.load_builder(native_path))
    got = port_mesh([objs["blob4"]])
    assert_same_octree(got, built(objs, "blob4_fma", "jax"))


def test_the_host_library_is_built_in_build_host():
    path = _build.build_host()
    assert path.parent == REPO / "build" / "host" and path.name.startswith("librpt_octree-")
    assert "-ffp-contract=off" in _build.HOST_FLAGS
    assert not any(f.startswith(("-march", "-mtune", "-ffast-math", "-Ofast"))
                   for f in _build.HOST_FLAGS)
    assert octree.load_builder(path).rpt_octree_build is not None


def test_no_port_module_reads_the_native_octree():
    """The port keeps its own builder: no module names the JAX-era library
    or reads native/ for the octree."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "libRptOctree" not in text, path
        assert "native/octree" not in text, path
    text = (PORT / "models" / "octree.py").read_text()
    assert '"native"' not in text and "native/" not in text


def test_a_build_without_a_compiler_raises(objs, tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-cxx"))
    monkeypatch.setattr(_build, "HOST_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="no-such-cxx"):
        _build.build_host()
    monkeypatch.setattr(octree, "_LIB", None)
    with pytest.raises(RuntimeError, match="no-such-cxx"):  # no numpy fallback
        port_mesh([objs["one_triangle"]])
    assert not list((tmp_path / "host").iterdir())


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'octree_builder.cpp:1: error: broken on purpose' >&2\n"
                   "exit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(_build, "HOST_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="broken on purpose") as err:
        _build.build_host()
    assert "broken-cxx" in str(err.value)
    assert not list((tmp_path / "host").iterdir())


_BUILD_AND_LOAD = """
import pathlib, sys
from relativitypathtracer_tpu_torch.models import obj_loader, octree
from relativitypathtracer_tpu_torch.models.mesh import HostMesh
from relativitypathtracer_tpu_torch.ops.kernels import _build
_build.HOST_DIR = pathlib.Path(sys.argv[1])
mesh = HostMesh()
obj_loader.read_obj(sys.argv[2], mesh)
print(octree._library()._name, len(mesh.octree), len(mesh.octree.oct_tris))
"""


def test_two_processes_build_at_once(objs, tmp_path):
    """Two processes that find no library build it side by side, each under
    its own temporary name, and both load the one library."""
    host = tmp_path / "host"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(host), objs["blob2"]],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env={**os.environ, "PYTHONPATH": str(REPO)})
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = [out.split() for out, _ in outs]
    want = built(objs, "blob2", "cpp").octree
    assert lines[0] == lines[1]
    assert lines[0][1:] == [str(len(want)), str(len(want.oct_tris))]
    assert [p.name for p in host.iterdir()] == [pathlib.Path(lines[0][0]).name]
