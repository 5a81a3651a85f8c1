"""Planning, cost model, Level-2 store, executor and segment runners."""
