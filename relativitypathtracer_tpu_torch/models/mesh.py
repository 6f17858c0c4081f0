"""Host-side aggregate mesh container.

All imported OBJ meshes share one flat pool, mirroring the reference's single
global Mesh (Mesh.h:5-16, Render.cpp:20).
Triangles are stored as a flat stream of 9 ints per triangle:
[v, uv, n] x 3 (Render.cpp:501-503).
"""

from __future__ import annotations

import dataclasses

from .octree import OctreeArrays


@dataclasses.dataclass
class HostMesh:
    vertices: list = dataclasses.field(default_factory=list)  # of (3,) float
    triangles: list = dataclasses.field(default_factory=list)  # flat ints, 9/tri
    uvs: list = dataclasses.field(default_factory=list)  # of (2,) float
    normals: list = dataclasses.field(default_factory=list)  # of (3,) float
    octree: OctreeArrays = dataclasses.field(default_factory=OctreeArrays.empty)
    mesh_indices: list = dataclasses.field(default_factory=list)  # root node per imported mesh
    # root node index -> (first_tri, end_tri) triangle range seeded at build
    # time; used by the brute-force (non-octree) mesh path.
    root_tri_ranges: dict = dataclasses.field(default_factory=dict)
    # root node index -> unique triangle ids reachable through the root's
    # octree subtree (foreign tris outside the root bounds are SAT-culled,
    # matching the reference's effective multi-mesh behavior)
    root_tri_lists: dict = dataclasses.field(default_factory=dict)

    @property
    def num_tris(self) -> int:
        return len(self.triangles) // 9
