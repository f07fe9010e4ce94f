"""K4 (the attention backward) on the CLIP tower: its share of its
roofline at the tower's shape, over the device time of all its launches
(a delta pass and the main kernel a call)."""
from hoibench import roofline as RL
from hoibench.readers import clip_shape, roofline


def read(runs):
    def bound(run, hw):
        b, h, length, d = clip_shape(run)
        return RL.k4(b, h, length, d, 4)[0] / 2
    return roofline(runs, lambda n: "attn_bwd" in n and "dbias" not in n,
                    bound)
