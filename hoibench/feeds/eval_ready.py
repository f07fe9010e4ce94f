"""The ``eval``/``ready`` feed: ``graphed(make_eval_step(cfg))`` over the
mix's host batches, outputs to the host every batch
(``cells.eval_ready``), judged by ``cells.check_eval``."""
from hoibench import cells as C, model as M, traffic as T


def run(run, t_start):
    run.training = False
    return C.check_eval(run, *C.eval_ready(run, t_start))


def inputs(run, rc, cfg, caches):
    """Two batches of the mix, as the comparison samples two."""
    pool, _ = T.make_batches(run.seed, run.config, run.traffic,
                             cfg.upt.num_classes,
                             pixels=M.pixel_maker(run.device),
                             clip_resolution=cfg.upt.clip_resolution)
    return pool[:2]
