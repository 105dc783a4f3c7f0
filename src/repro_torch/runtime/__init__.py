"""Step functions of the port: the train step, its state, and thin
prefill and decode wrappers (``steps``); fleet placement over a device
mesh (``sharding``)."""
