"""The fmax phase over a mesh of devices in one process, and the exchange
of its products between hosts (counterpart of pinocchio_tpu/parallel, its
single-process part): ``pfft`` holds the mesh, the slab, pencil and volume
decompositions and the distributed transforms; ``driver`` the sharded IC,
collapse cycle, LPT stage and hand-off; ``exchange`` the cross-host product
exchange; ``multihost`` sub-box ownership and a host's local fetch.  A mesh
is a list of torch devices: cuda:0..n-1, or a list that repeats a device
(the tests' CPU meshes, one card holding every shard)."""
