"""Host-side scheduling helpers the cluster compile step evaluates."""
