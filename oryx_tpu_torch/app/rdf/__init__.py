"""The random decision forest app: trees, PMML, the forest walk and
the histogram trainer on the card, and the batch, speed and serving
tiers."""
