"""The plain float32 reference: the network, preprocess and postprocess,
and the training step. It imports nothing of the program."""
