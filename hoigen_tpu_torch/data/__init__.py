from .hicodet import HICODetDataset  # noqa: F401
from .vcoco import VCOCODataset  # noqa: F401
from .factory import DataFactory, collate_batch  # noqa: F401
from .samplers import (GroupedBatchSampler, IndexSequentialSampler,  # noqa: F401
                       OnlineBatchSampler, ParallelOnlineBatchSampler,
                       StratifiedBatchSampler, create_aspect_ratio_groups)
