"""ReID training on the card: losses, optimizer profiles, trainer, ranking
evaluation and CLIP-ReID's stage-1 prompt learning."""
