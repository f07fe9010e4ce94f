"""K1 on the CLIP tower in training (f32 route): its share of its
roofline, the bound at the tower's shape over the device time of its
launches."""
from hoibench import roofline as RL
from hoibench.readers import clip_shape, is_k1_f32, roofline


def read(runs):
    def bound(run, hw):
        b, h, length, d = clip_shape(run)
        return RL.k1(b, h, length, length, d, 4)[0]
    return roofline(runs, is_k1_f32, bound)
