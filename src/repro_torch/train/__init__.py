"""Training of the port: AdamW, gradient compression, train steps."""
