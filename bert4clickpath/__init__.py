"""bert4clickpath — a JAX sequential-recommendation framework.

A from-scratch JAX/XLA/shard_map/Pallas rebuild of the capabilities of
MiladShahidi/BERT4ClickPath (see SURVEY.md): bidirectional Transformer over
clickstream sequences, Cloze/masked-item training, multi-variable events,
pluggable task heads, masked losses/metrics, recall@k / NDCG@k eval,
data/model-parallel execution over a jax.sharding.Mesh with row-sharded
embedding tables, and a fused full-catalog softmax CE (Pallas kernels
through Triton on the GPU) on the hot path.
"""

__version__ = "0.1.0"

from bert4clickpath.config import (  # noqa: F401
    FeatureConfig,
    HeadConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from bert4clickpath.models.model import ClickstreamModel  # noqa: F401
from bert4clickpath.vocab import Vocabulary  # noqa: F401
