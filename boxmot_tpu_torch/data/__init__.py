"""Dataset access for the evals: MOT Challenge, MMOT and the detection cache."""
