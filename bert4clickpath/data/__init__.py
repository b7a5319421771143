from bert4clickpath.data.cloze import ClozeBatch  # noqa: F401
from bert4clickpath.data.pipeline import ClozeDataset  # noqa: F401
