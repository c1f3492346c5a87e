"""Core paper definitions: archetypes and the scalar REI front-end."""
