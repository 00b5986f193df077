"""Cluster-state emulation for the host route: the resource store and pod
queue, the predictive strategy, the event recorder, and the report model and
printers."""
