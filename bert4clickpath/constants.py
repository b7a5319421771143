"""Reserved-token and label-pad constants.

Mirrors the reserved-vocabulary contract of the reference
(``clickstream_transformer/constants.py:1-39``): ten reserved rows are
prepended to every feature vocabulary, and labels are padded with ``-1``.

Differences from the reference:

* Tokens are *integer ids* end-to-end. The string->id mapping lives in the
  host-side input pipeline (:mod:`bert4clickpath.vocab`), because XLA has
  no string tensors; the reference instead baked ``tf.lookup`` tables into the
  model (clickstream_transformer.py:247-258).
* ``MASK_ID`` is the index of ``[MASK]`` (=1). The reference computed its
  ``INPUT_MASK`` constant from ``[UNK]``'s index by mistake
  (constants.py:28) but only ever matched the *string* ``[MASK]``, so the
  faithful integer id is 1.
* ``LABEL_PAD`` is an integer (-1), not the reference's float -1.0
  (constants.py:1): labels are int32 class ids in this build.
"""

from __future__ import annotations

LABEL_PAD: int = -1  # labels padded with -1; 0 is a real class id

NUM_RESERVED_TOKENS: int = 10

PAD_TOKEN = "[PAD]"
MASK_TOKEN = "[MASK]"
UNK_TOKEN = "[UNK]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
NA_TOKEN = "[NA]"  # missing event or item

# Order matters: these are vocabulary rows 0..9 for every feature
# (reference constants.py:14-24).
RESERVED_TOKENS: list[str] = [
    PAD_TOKEN,
    MASK_TOKEN,
    UNK_TOKEN,
    CLS_TOKEN,
    SEP_TOKEN,
    NA_TOKEN,
]
RESERVED_TOKENS += [
    f"[RESERVED_{i}]" for i in range(len(RESERVED_TOKENS), NUM_RESERVED_TOKENS)
]

PAD_ID: int = RESERVED_TOKENS.index(PAD_TOKEN)  # 0
MASK_ID: int = RESERVED_TOKENS.index(MASK_TOKEN)  # 1
UNK_ID: int = RESERVED_TOKENS.index(UNK_TOKEN)  # 2
CLS_ID: int = RESERVED_TOKENS.index(CLS_TOKEN)  # 3
SEP_ID: int = RESERVED_TOKENS.index(SEP_TOKEN)  # 4
NA_ID: int = RESERVED_TOKENS.index(NA_TOKEN)  # 5

# Cloze-task hyper-parameters (reference examples/BERT4Rec/source/cloze_constants.py:1-2).
MAX_MASKED_ITEMS: int = 10
MASKED_PERCENTAGE: float = 0.4

# Canonical name for the item-embedding parameter subtree; checkpoints rely on
# it for transfer learning (reference constants.py:39 used a Keras layer name
# the same way).
ITEM_EMBEDDING_PARAM_NAME = "item_embedding"
