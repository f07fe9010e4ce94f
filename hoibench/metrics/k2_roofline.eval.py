"""K2 (the fused layer1 tail of the DETR backbone) at eval: its share of
its roofline at each traced step's layer1 plane."""
from hoibench import roofline as RL
from hoibench.readers import is_k2, roofline, rows


def read(runs):
    def bound(run, hw):
        return RL.k2(rows(run), *RL.k2_plane(hw))[0]
    return roofline(runs, is_k2, bound)
