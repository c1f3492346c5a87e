# Distribution substrate: logical-axis sharding, single device only.
