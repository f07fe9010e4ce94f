"""K1 in the DETR encoder at eval (bf16, the key bias of the padding):
its share of its roofline at each traced step's padded shape."""
from hoibench import roofline as RL
from hoibench.readers import is_k1_bf16, roofline, rows


def read(runs):
    def bound(run, hw):
        length = RL.detr_tokens(hw)
        return RL.k1(rows(run), 8, length, length, 32, 2,
                     key_bias=True)[0]
    return roofline(runs, is_k1_bf16, bound)
