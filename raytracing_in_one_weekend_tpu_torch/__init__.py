"""PyTorch / CUDA port of the path tracer, for NVIDIA Hopper (H100).

Counterpart of the JAX package `raytracing_in_one_weekend_tpu`, which
stays in the repository as the reference.  The layout mirrors it module
for module, so each module's counterpart is easy to find; inside, the
code is plain PyTorch: functions on tensors, frozen dataclasses of
tensors with a `.to(device)` method, an explicit `device` everywhere and
an explicit `torch.Generator` for every random draw on the host.

Ported for sphere scenes and triangle meshes: the forward render (the
book-cover main path, `render.renderer.render_batch` ->
`ops.megatrace.sample_batch`; meshes of more than TRI_MAX (4096) triangles
through its streamed arm, and above 65536 through the bounce-synchronous
`ops.meshtrace.sample_batch_sync`, up to TRI_STREAM_MAX (262144)), its
gradient for meshes of at most TRI_MAX triangles
(`ops.megatrace_replay.sample_batch_diff` -> the backward kernel; bigger
ones take the differentiable wavefront) and the wavefront integrator
(`render.integrator.trace`, threefry keys in `core.rng`), which carries
the AOV gradients and the autofocus raycast; meshes come from
`models.meshes` (generators, an OBJ reader) through
`SceneBuilder.add_mesh` / `add_triangle`.
Each kernel is hand-written CUDA under `csrc/`, launched on CUDA tensors;
on CPU tensors its plain PyTorch version runs.  Everything the port does
not cover yet raises NotImplementedError naming its ROADMAP item.

This package never imports jax, nor the JAX package.
"""

__version__ = "0.1.0"
