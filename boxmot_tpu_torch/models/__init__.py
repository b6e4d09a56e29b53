"""The port's models: every ReID backbone of the JAX package (OSNet, ResNet,
MobileNetV2, LMBN, MLFN, CSPReID, HACNN, the ViTs, CSL-TinyViT, CLIP-ReID
and its tokenizer), YOLOX, and their weight loading."""
