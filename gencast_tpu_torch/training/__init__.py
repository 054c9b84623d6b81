"""Training: the loss step, its optimizer and the training CLI."""
