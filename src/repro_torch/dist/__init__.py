# Distribution substrate: a device mesh that shards the fleet plane's lanes.
