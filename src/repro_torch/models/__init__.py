"""Model code of the port: config, layers, attention, blocks, model."""
