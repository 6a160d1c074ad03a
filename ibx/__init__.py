"""ibx — an immersed-boundary flow-solver framework in JAX.

Built from scratch in JAX/XLA with the capabilities of
``pedrosecchi67/ImmersedBoundary.jl`` (see SURVEY.md for the blueprint):
triangulated surfaces -> block-structured octree/quadtree Cartesian meshes ->
partitioned domains compiled to static gather/scatter index tables ->
finite-volume operators, ghost-cell immersed boundaries, compressible-flow
physics and solver acceleration, all running on device under ``jit`` and
sharded over a device mesh.
"""

__version__ = "0.1.0"
