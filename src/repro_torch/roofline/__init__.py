"""The roofline of a step on one card: the three-term bound (``analysis``)
and the counts the dry run takes under ``FakeTensorMode`` (``dispatch``)."""
