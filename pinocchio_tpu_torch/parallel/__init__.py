"""The fmax phase over a mesh of devices in one process (counterpart of
pinocchio_tpu/parallel, its single-host part): ``pfft`` holds the mesh, the
slab, pencil and volume decompositions and the distributed transforms;
``driver`` the sharded IC, collapse cycle, LPT stage and hand-off.  A mesh is
a list of torch devices: cuda:0..n-1, or a list that repeats a device (the
tests' CPU meshes, one card holding every shard)."""
