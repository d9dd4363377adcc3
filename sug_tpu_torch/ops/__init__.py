"""Point-cloud ops: geometry, and the EdgeConv kernel with its plain version."""
