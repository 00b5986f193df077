"""The host scheduling engine, line for line kube-scheduler's: predicates,
priorities, the generic scheduler with preemption, the plugin registry and
providers, volume binding, extenders, the scheduler cache, the scheduling
queues and the equivalence cache; the cluster compile step of the device
routes evaluates the same predicate and priority helpers."""
