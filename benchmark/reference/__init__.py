"""The plain reference: the recipe's STFT, the autoencoder's forward, loss
and Adam, in plain PyTorch, imported by nothing of the program and
importing nothing of it."""
