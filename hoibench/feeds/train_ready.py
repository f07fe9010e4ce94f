"""The ``train``/``ready`` feed: ``Trainer.run_epoch`` over
``GraphedTrainStep(make_train_step(...))`` fed from the mix's host
batches (``cells.train_ready``), judged by ``cells.check_train``."""
from hoibench import cells as C, model as M, traffic as T


def run(run, t_start):
    return C.check_train(run, *C.train_ready(run, t_start))


def inputs(run, rc, cfg, caches):
    """The batches the comparison takes: the first three steps'."""
    pool, steps = T.make_batches(run.seed, run.config, run.traffic,
                                 cfg.upt.num_classes, caches=caches,
                                 pixels=M.pixel_maker(run.device),
                                 clip_resolution=cfg.upt.clip_resolution)
    return [pool[i] for i in steps[:3]]


def run_seed(run, rc):
    """The seed of the steps' dropout draws."""
    return M.dropout_seed(run.seed)
