"""The k-means clustering app: trainer, evaluation, speed and serving."""
