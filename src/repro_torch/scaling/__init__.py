"""Control plane: controller protocol, policies, registry, scenarios."""
