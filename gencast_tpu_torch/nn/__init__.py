"""Neural-net building blocks (torch.nn)."""
