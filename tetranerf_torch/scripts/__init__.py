"""Console scripts of the port that serve a trained scene: ``render`` and
``viewer``."""
