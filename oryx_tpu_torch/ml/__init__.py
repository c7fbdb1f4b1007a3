"""Generic batch-ML machinery: hyperparameter search, the per-generation
update loop, and the model-integrity gates."""
