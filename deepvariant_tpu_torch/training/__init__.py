"""Training the genotype classifier: config, input pipeline, metrics, the
train and eval steps, the streaming and the resident trainers."""
