"""V-COCO label tables the port needs (the part of
``hoigen_tpu/labels/vcoco.py`` that the eval step reads): the 91-slot COCO
category table and the gather that takes a COCO-pretrained DETR's 92
logits down to 81 (80 classes and no-object). Constants only; the JSON
tables come with the slice that ports host evaluation."""

# the standard 91-slot COCO category table (public DETR convention: index
# 0 and ten other slots are 'N/A' holes; person = slot 1)
COCO_91_CLASSES = (
    "N/A", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A",
    "backpack", "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase",
    "frisbee", "skis", "snowboard", "sports ball", "kite", "baseball bat",
    "baseball glove", "skateboard", "surfboard", "tennis racket", "bottle",
    "N/A", "wine glass", "cup", "fork", "knife", "spoon", "bowl", "banana",
    "apple", "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed", "N/A",
    "dining table", "N/A", "N/A", "toilet", "N/A", "tv", "laptop", "mouse",
    "remote", "keyboard", "cell phone", "microwave", "oven", "toaster",
    "sink", "refrigerator", "N/A", "book", "clock", "vase", "scissors",
    "teddy bear", "hair drier", "toothbrush",
)


def detr_reserve_indices():
    """The 81 logit indices, in order, of a 92-logit COCO-pretrained DETR
    head that the V-COCO model keeps: the 80 real classes of the 91-slot
    table (N/A holes dropped, person first) and the no-object logit at 91.
    Gathered before the postprocess softmax, so scores normalise over the
    81."""
    return [i for i, n in enumerate(COCO_91_CLASSES) if n != "N/A"] + [91]
