"""raytracing_test_tpu — a differentiable sparse-voxel raytracing framework.

A from-scratch JAX/XLA re-expression of the capabilities of the reference
C++/OpenGL engine (reedthorngag/raytracing_test):

- sparse 64-ary voxel world ("tetrahexa tree") with multi-resolution leaves and
  incremental device mirroring  (ref: src/voxel_data/tetrahexa_tree.cpp)
- seeded OpenSimplex terrain generation  (ref: src/world_gen.cpp)
- DDA/Amanatides-Woo ray-march rendering with reflection, refraction (animated
  water), sun shadows, skybox + sun disc, face-shaded diffuse
  (ref: src/shaders/low_res.frag)
- hemisphere-sampled diffuse/AO  (ref: src/shaders/light_scattering.frag)
- CPU picking raycaster + interactive put/delete editing  (ref: src/ray_caster.cpp,
  src/input.cpp)

plus, new for this framework: differentiability w.r.t. voxel densities/albedos and
camera pose, and multi-device execution via jax.sharding meshes (ray/tile
sharding, spatial world sharding, gradient psum).

Layer map (see COMPONENTS.md for the reference-parity matrix):
    core/      voxel types, color packing, the host-side sparse tree, flattening
    worldgen/  seed-exact OpenSimplex noise + the 3-octave terrain recipe
    oracle/    numpy CPU reference renderer — the correctness oracle
    render/    pure-JAX vectorized renderer (forward + differentiable volumetric)
    ops/       low-level ops (dedup scatter VJP, one-hot lookups, morton)
    parallel/  device meshes, ray/tile sharding, spatial world sharding
    app/       CLI driver, interactive edit loop, inverse-rendering fit, ckpt
    native/    C++ runtime (tree/allocator/worldgen) with ctypes bindings
"""

__version__ = "0.1.0"
