from bert4clickpath.parallel.mesh import make_mesh  # noqa: F401
