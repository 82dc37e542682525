"""One driver per traffic kind (``traffic/<mix>.json``'s ``driver``)."""
