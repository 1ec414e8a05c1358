"""GAN training: the adversarial step, the fault-tolerant loop and its checkpoints."""
