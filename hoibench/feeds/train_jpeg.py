"""The ``train``/``jpeg`` feed: the training step fed from JPEG files by
the CLI's own input path (``jpeg.train_jpeg``), judged by
``jpeg.check_train_jpeg``."""
from hoibench import jpeg


def run(run, t_start):
    return jpeg.check_train_jpeg(run, *jpeg.train_jpeg(run, t_start))


def inputs(run, rc, cfg, caches):
    """The first three batches the CLI's input path builds."""
    return jpeg.loader_batches(run, rc)


def run_seed(run, rc):
    """The seed of the steps' dropout draws: the CLI's."""
    return rc.seed
