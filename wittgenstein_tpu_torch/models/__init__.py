"""Protocol models.  Import the model module you need (e.g.
`models.handel`); this package imports nothing itself."""
