from bert4clickpath.models.model import ClickstreamModel  # noqa: F401
