"""Console scripts of the port: preprocessing (``triangulate`` and the four
``process_*`` dataset converters, with :mod:`.common`) and serving a trained
scene (``render`` and ``viewer``)."""
