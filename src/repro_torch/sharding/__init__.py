"""Sharding: partition specs keyed on the port's parameter and cache names
(:mod:`.specs`) and the logical-name constraint context the models call
(:mod:`.ctx`)."""
