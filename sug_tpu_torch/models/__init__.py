"""Models: NetMDA(DGCNN) and its building blocks."""
