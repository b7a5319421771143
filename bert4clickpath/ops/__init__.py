from bert4clickpath.ops import losses, masking, metrics  # noqa: F401
