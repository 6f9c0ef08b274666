"""Training of the mel VQ-VAE: train state with the fused optimizer,
losses, the train and eval steps, the epoch driver and checkpoints."""
