"""The harness's general parts: the specification's lookup by name, data
seeding, the traffic loops, spans, the device trace's reduction, the
comparison with the plain reference and the import guard. Nothing here
belongs to one configuration, traffic mix or metric."""
