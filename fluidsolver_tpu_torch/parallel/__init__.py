"""The x-slab mesh: port of ``fluidsolver_tpu.parallel``.

``mesh.SlabMesh`` is the port's one-axis ``jax.sharding.Mesh`` and its
functions the collectives of ``shard_map``'s bodies; ``halo``,
``dist_poisson``, ``cuda_shard`` and ``dist_vof`` follow the JAX modules of
those names (``pallas_shard`` becomes ``cuda_shard``). One Python process
drives every slab, as one JAX controller drives every device of a mesh.
"""
