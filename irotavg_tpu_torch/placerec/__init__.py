"""L3b — place recognition: a DBoW2-compatible vocabulary with a batched
tree descent on the frames' device, sparse BoW vectors, the six DBoW2
scorers, an inverted-file database with the reference's loop-candidate
cascade, the loop detector that the engine and the offline pipeline share,
and the two vocabulary trainers (port of
``irotavg_tpu/placerec``)."""

from irotavg_tpu_torch.placerec.bow import bow_score  # noqa: F401
from irotavg_tpu_torch.placerec.database import ViewDatabase  # noqa: F401
from irotavg_tpu_torch.placerec.loop import LoopDetector  # noqa: F401
from irotavg_tpu_torch.placerec.vocabulary import (  # noqa: F401
    Vocabulary, train_vocabulary, train_vocabulary_flat,
)
